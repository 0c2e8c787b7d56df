"""zero_to_fp32 — consolidate a training checkpoint into one fp32 weights
file (counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py``; reference
``utils/zero_to_fp32.py``). Checkpoints store whole name-keyed tensors, so
consolidation reads the master weights (falling back to the model weights,
upcast, when the master aliases them) and writes a single fp32 npz; it
reads the checkpoints of both packages alike::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 ckpt_dir output.npz [--tag T]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch


def convert_zero_checkpoint_to_fp32_state_dict(
        ckpt_dir: str, output_file: str,
        tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    from ..runtime.checkpointing import FlatNpz, get_latest_tag
    if tag is None:
        tag = get_latest_tag(ckpt_dir)
        if tag is None:
            raise FileNotFoundError(f"no 'latest' tag in {ckpt_dir}")
    d = os.path.join(ckpt_dir, tag)
    with FlatNpz(os.path.join(d, "optim_states.npz")) as r:
        names = {k[len("master/"):]: k for k in r.keys()
                 if k.startswith("master/")}
        state_dict = {k: r[src].to(torch.float32).numpy()
                      for k, src in names.items()}
    if not state_dict:
        # fp32 and pure-bf16 runs alias the master into the model file
        with FlatNpz(os.path.join(d, "model_states.npz")) as r:
            state_dict = {k: r[k].to(torch.float32).numpy() for k in r.keys()}
    np.savez(output_file, **state_dict)
    return state_dict


def main(argv=None):
    p = argparse.ArgumentParser(prog="zero_to_fp32")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, args.tag)
    total = sum(int(np.prod(v.shape)) for v in sd.values())
    print(f"wrote {len(sd)} fp32 tensors ({total:,} params) "
          f"to {args.output_file}")


if __name__ == "__main__":
    main()
