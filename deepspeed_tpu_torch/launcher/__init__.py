"""Launchers (counterpart of ``deepspeed_tpu/launcher/``): the per-node
spawner ``launch.py``. The multi-node runner, supervisor and ssh
backends wait for ROADMAP.md item 4.3."""
