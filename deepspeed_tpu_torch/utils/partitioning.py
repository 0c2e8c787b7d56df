"""The ``/``-joined key path of the checkpoint format (counterpart of
``path_str`` in ``deepspeed_tpu/utils/partitioning.py``; the tensor-
parallel sharding rules there wait for ROADMAP item 4.1)."""

from __future__ import annotations


def path_str(path) -> str:
    """'transformer/h_0/attn/c_attn/kernel'-style key path string: keys
    (``.key``), indices (``.idx``) or plain values, joined by ``/``."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)
