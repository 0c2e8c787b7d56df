"""``python -m deepspeed_tpu_torch.launcher``: the runner's CLI (the JAX
package's ``dstpu``; see ``runner.py``)."""

from .runner import main

if __name__ == "__main__":
    main()
