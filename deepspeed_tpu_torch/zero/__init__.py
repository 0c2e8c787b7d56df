"""deepspeed_tpu_torch.zero — the user-facing ZeRO API (counterpart of
``deepspeed_tpu/zero/__init__.py``; reference
``runtime/zero/partition_parameters.py``: ``Init`` at :539,
``GatheredParameters`` at :1519; ``utils/init_on_device.py``:
``OnDevice``).

- :class:`Init`: a model built inside ``with zero.Init(config=...)`` (stage
  3) is built on ``meta``, holding no values. ``initialize`` then fills
  each rank's slabs straight from the model's values, one leaf at a time:
  a ``Transformer`` redraws its seeded values (the same ones a model built
  outside ``Init`` gets), any other module materializes one submodule at
  a time through its ``reset_parameters``. No rank ever holds the whole
  model.
- :class:`GatheredParameters`: whole parameters for the block; with
  ``modifier_rank``, that rank's edits are broadcast and written back into
  every rank's master and parameter slabs on exit.
- :class:`OnDevice`: build a model with a default device and dtype.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from ..runtime.zero.stages import ZeroShardingPolicy

_ACTIVE_INIT = None


class Init(contextlib.AbstractContextManager):
    """``with zero.Init(config=ds_config): model = build_model(...)``:
    modules built inside hold their parameters on ``meta``; the engine
    places each rank's ZeRO-3 slabs. Enabled only at ZeRO stage 3 (as in
    the JAX package); otherwise a no-op."""

    def __init__(self, config=None, enabled: bool = True):
        from ..config.config import load_config
        self.config = load_config(config)
        self.enabled = enabled and self.config.zero_optimization.stage == 3
        self._meta = None

    def __enter__(self):
        global _ACTIVE_INIT
        if self.enabled:
            _ACTIVE_INIT = self
            self._meta = torch.device("meta")
            self._meta.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE_INIT
        _ACTIVE_INIT = None
        if self._meta is not None:
            meta, self._meta = self._meta, None
            meta.__exit__(*exc)
        return False


def get_active_init() -> Optional[Init]:
    return _ACTIVE_INIT


def _reset_values(module: nn.Module, device
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Materialize the meta parameters one owning submodule at a time
    (``to_empty`` + its ``reset_parameters``) and yield them by name."""
    for mname, mod in module.named_modules():
        own = [n for n, p in mod._parameters.items()
               if p is not None and p.is_meta]
        if not own:
            continue
        if not hasattr(mod, "reset_parameters"):
            raise ValueError(
                f"module '{mname or type(mod).__name__}' was built under "
                "zero.Init but has no reset_parameters() to draw its "
                "values from")
        mod.to_empty(device=device, recurse=False)
        mod.reset_parameters()
        for n in own:
            yield f"{mname}.{n}".lstrip("."), mod._parameters[n].detach()


def init_values(model: nn.Module, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(parameter name, whole value) of a model built under :class:`Init`,
    one leaf at a time."""
    seeded = getattr(model, "zero_init_values", None)
    if seeded is not None:
        return seeded(device=device)
    return _reset_values(model, device)


def materialize(model: nn.Module, values: Iterable[Tuple[str, torch.Tensor]]
                ) -> None:
    """Replace each named meta parameter by its whole value (the engine
    without a process group: ZeRO over one rank keeps everything)."""
    owners = {}
    for mname, mod in model.named_modules():
        for n, p in mod._parameters.items():
            if p is not None:
                owners[f"{mname}.{n}".lstrip(".")] = (mod, n)
    for name, value in values:
        mod, n = owners[name]
        old = mod._parameters[n]
        mod._parameters[n] = nn.Parameter(
            value.detach().to(torch.float32).clone(),
            requires_grad=old.requires_grad)
    left = [n for n, (m, k) in owners.items() if m._parameters[k].is_meta]
    if left:
        raise ValueError(f"no values for the meta parameters {left[:5]}")


class GatheredParameters(contextlib.AbstractContextManager):
    """Whole ``params`` (a parameter, an iterable of them or a module) in
    their ``.data`` for the block (reference partition_parameters.py:1519).
    Parameters of a data-parallel engine are all-gathered where sharded
    (every rank must enter together). With ``modifier_rank``, mutate them
    in place on that rank: on exit its values are broadcast to every rank
    and written back into the engine's master and parameter slabs.
    Parameters no engine partitions are whole already: a no-op. Returns
    the list of parameters."""

    def __init__(self, params: Union[nn.Parameter, Iterable, nn.Module],
                 modifier_rank: Optional[int] = None, fwd_module=None,
                 enabled: bool = True):
        if isinstance(params, nn.Module):
            params = list(params.parameters())
        elif isinstance(params, torch.Tensor):
            params = [params]
        self.params = [p for p in params if p is not None]
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self._ctx = None

    def __enter__(self):
        if not self.enabled:
            return self.params
        owners = {getattr(p, "ds_zero", None) and p.ds_zero.partition
                  for p in self.params} - {None}
        if len(owners) > 1:
            raise ValueError("GatheredParameters: parameters of more than "
                             "one engine")
        if owners:
            self._ctx = owners.pop().gathered(self.params,
                                              self.modifier_rank)
            self._ctx.__enter__()
        return self.params

    def __exit__(self, exc_type, exc, tb):
        if not self.enabled:
            return False
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            return bool(ctx.__exit__(exc_type, exc, tb))
        return False


class OnDevice(contextlib.AbstractContextManager):
    """Build modules with ``device`` as the default device (``"meta"``:
    shapes only) and floating tensors in ``dtype`` (reference
    ``deepspeed/utils/init_on_device.py``)::

        with zero.OnDevice(dtype=torch.bfloat16, device="cuda"):
            model = MyModel()
        od = zero.OnDevice(device="meta"); shapes = od.init(MyModel)
    """

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 device: Optional[str] = None, enabled: bool = True):
        self.dtype = dtype
        self.device = device
        self.enabled = enabled
        self._dev = None
        self._old_dtype = None

    def __enter__(self):
        if self.enabled:
            if self.device is not None:
                self._dev = torch.device(self.device)
                self._dev.__enter__()
            if self.dtype is not None:
                self._old_dtype = torch.get_default_dtype()
                torch.set_default_dtype(self.dtype)
        return self

    def __exit__(self, *exc):
        if self._old_dtype is not None:
            torch.set_default_dtype(self._old_dtype)
            self._old_dtype = None
        if self._dev is not None:
            dev, self._dev = self._dev, None
            dev.__exit__(*exc)
        return False

    def init(self, init_fn, *args, **kwargs):
        """``init_fn(*args, **kwargs)`` inside this context."""
        with self:
            return init_fn(*args, **kwargs)


__all__ = ["Init", "GatheredParameters", "OnDevice", "ZeroShardingPolicy",
           "get_active_init", "init_values", "materialize"]
