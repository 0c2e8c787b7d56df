"""Launchers (counterpart of ``deepspeed_tpu/launcher/``): the runner CLI
(``runner.py``, ``python -m deepspeed_tpu_torch.launcher``), the
per-node bootstrap ``launch.py``, the fail-fast supervisors
(``supervisor.py``), the scheduler backends' commands
(``multinode_runner.py``) and ``ds_ssh.py``."""
