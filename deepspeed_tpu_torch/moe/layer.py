"""MoE layer: expert-parallel mixture of experts over the mesh's
``expert`` axis (counterpart of ``deepspeed_tpu/moe/layer.py``; reference
``deepspeed/moe/layer.py`` MoE, ``experts.py`` and the MOELayer pipeline
of ``sharded_moe.py``: gate -> dispatch -> all_to_all -> experts ->
all_to_all -> combine).

Parameters keep the JAX package's names and layout: the router
``gate/kernel`` [H, E] in f32 and the stacked expert kernels
``experts/{fc,gate,proj}/kernel`` [E, in, out] with biases [E, out].

Gating groups. The JAX layer regroups its tokens into G = data x expert x
seq groups (the token dim's mesh sharding) and gates each group into its
own queues of Cg slots. Here:

* in a process group whose world the global mesh spans, each rank's
  tokens are its group: the rank gates them, exchanges its [E, Cg, H]
  queues over the ``expert`` group with :func:`comm.all_to_all` (split E,
  concatenate the queue dim), runs its local experts (the expert module
  holds E / ep of them once the engine has split the expert leaves) and
  exchanges the outputs back. The exchange is issued even over a group
  of one rank, where it moves nothing. Under a pipeline the same holds
  inside each stage: a micro-batch's group is the rank's rows of it (its
  ``(data, expert)`` coordinate's, as the JAX pipelined model's micro-
  batch spec shards them) and the exchange crosses the rank's own expert
  group, the ranks of its stage;
* with a global mesh and no process group of its size (one process
  standing in for the mesh), the layer regroups its tokens into the
  mesh's G groups as the JAX layer does and runs every expert locally;
  the JAX layer falls back to one ungrouped layout when G does not
  divide the tokens, which raises here (ROADMAP.md Queue 3);
* with no mesh: one group, every expert local.

Under tensor parallelism (``tp``, the ``TPContext`` that
``Transformer.set_tp`` gives the layer) the expert kernels are this
rank's shards by the ``experts/*`` rules: ``fc`` / ``gate`` column-
parallel within each local expert, ``proj`` row-parallel. The tokens and
the router are replicated over ``model``, so every model rank gates
alike and its exchange runs within its own model index's expert group;
the queues' gradients and the combine weights' are summed over
``model`` (``comm.tp_copy_to``), the ``proj`` bias is added on model rank
0 only, and the combined partial outputs go through one
``comm.tp_reduce_from`` (the combine is linear).

With an engine's ``comm_plan`` routing the expert all-to-all to
``int8`` (``comm.planned.moe_exchange_spec``), the exchange is the
explicit pair of ``runtime/comm/quantized.py``: each expert's queue
blockwise int8 on the wire, its f32 scales beside it, and the backward
through the same int8 exchange.

Queues are formed by index: each kept (token, choice) has a unique
(expert, position) slot, every slot names the token that fills it (or a
zero row), the queues are one ``index_select`` of the tokens and the
combine gathers each choice's output row and weights it. This is the
one-hot einsum form of the JAX package written with indices; the einsum
form is :func:`moe_reference`, the plain version the tests hold it to.
Empty slots are computed like filled ones (their rows are zero), as in
the JAX layer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .sharded_moe import Route, compute_capacity, dense_from_route, route

TOKEN_AXES = ("data", "expert", "seq")


class _Params(nn.Module):
    """A leaf module's parameters under their flax names."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    @property
    def p(self) -> Dict[str, torch.Tensor]:
        # attribute lookup: a ZeRO-3 unit puts the gathered whole tensor
        # in the instance dict, ahead of the shard in _parameters
        return {name: getattr(self, name) for name in self._parameters}


def _edense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-expert dense: x [E, n, in] @ kernel [E, in, out] (+ bias
    [E, out]) in x's dtype. A kernel with an int8 ``kernel_scale`` is
    dequantized first (``models.generation._kernel_of``)."""
    from ..models.generation import _kernel_of
    y = torch.bmm(x, _kernel_of(p, x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)[:, None]
    return y


def tp_bias(p: Dict[str, torch.Tensor], tp) -> Dict[str, torch.Tensor]:
    """A row-parallel expert ``proj`` leaf under TP: its (replicated)
    bias added on model rank 0 only, as the partial sums are reduced
    after the combine, and its gradient summed over the model axis, so
    every rank holds the whole one. ``p`` itself without ``tp``."""
    if tp is None or "bias" not in p:
        return p
    b = p["bias"]
    if torch.is_grad_enabled():
        from .. import comm
        b = comm.tp_copy_to(b, axis=tp.axis)
    return dict(p, bias=b if tp.rank == 0 else b * 0)


class ExpertMLP(nn.Module):
    """The default expert, the transformer MLP: proj(gelu(fc(x))) with
    tanh GELU (flax ``nn.gelu``), E experts stacked: ``fc`` [E, H, F],
    ``proj`` [E, F, H] (+ biases [E, F] / [E, H])."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.fc = _Params(params["fc"])
        self.proj = _Params(params["proj"])
        self.tp = None

    @property
    def num_local(self) -> int:
        return self.fc.kernel.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, n, H] -> [E, n, H]: expert e applied to x[e]."""
        from ..models.transformer import _ACTIVATIONS
        return _edense(_ACTIVATIONS["gelu"](_edense(x, self.fc.p)),
                       tp_bias(self.proj.p, self.tp))


class GatedExpertMLP(nn.Module):
    """The SwiGLU expert (Mixtral; HF MixtralBlockSparseTop2MLP
    w1 / w3 / w2): proj(act(gate(x)) * fc(x)), E experts stacked."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 activation: str = "silu"):
        super().__init__()
        self.gate = _Params(params["gate"])
        self.fc = _Params(params["fc"])
        self.proj = _Params(params["proj"])
        self.activation = activation
        self.tp = None

    @property
    def num_local(self) -> int:
        return self.fc.kernel.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.transformer import _ACTIVATIONS
        act = _ACTIVATIONS[self.activation]
        h = act(_edense(x, self.gate.p)) * _edense(x, self.fc.p)
        return _edense(h, tp_bias(self.proj.p, self.tp))


def init_moe_params(hidden_size: int, num_experts: int, mlp_dim: int,
                    generator: torch.Generator, gated: bool = False,
                    use_bias: bool = True) -> Dict[str, Any]:
    """Random MoE parameters in f32: kernels normal with std
    1/sqrt(fan_in) (flax's lecun_normal scale), biases 0."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * (shape[-2] ** -0.5)

    def dense(fan_in, fan_out):
        p = {"kernel": normal(num_experts, fan_in, fan_out)}
        if use_bias:
            p["bias"] = torch.zeros(num_experts, fan_out, device=dev)
        return p

    experts = {"fc": dense(hidden_size, mlp_dim),
               "proj": dense(mlp_dim, hidden_size)}
    if gated:
        experts["gate"] = dense(hidden_size, mlp_dim)
    return {"gate": {"kernel": normal(hidden_size, num_experts)},
            "experts": experts}


def _bound_mesh():
    """The global mesh when the process group's world is its world."""
    from .. import comm
    from ..parallel.mesh import get_global_mesh
    mm = get_global_mesh()
    if mm is None or not comm.is_initialized() or \
            mm.world_size != comm.get_world_size():
        return None
    return mm


def gating_groups(tokens: int) -> Tuple[int, bool]:
    """(G, exchange): the number of gating groups among this process's
    ``tokens`` and whether the queues cross the ``expert`` group (see the
    module docstring)."""
    from ..parallel.mesh import get_global_mesh
    if _bound_mesh() is not None:
        return 1, True
    mm = get_global_mesh()
    if mm is None:
        return 1, False
    g = mm.axes_size(TOKEN_AXES)
    if g > 1 and tokens % g:
        raise NotImplementedError(
            f"MoE gating: {tokens} tokens do not split into the mesh's "
            f"{g} data x expert x seq groups; the JAX layer falls back to "
            "one ungrouped layout there, which is not ported to "
            "deepspeed_tpu_torch yet (see ROADMAP.md Queue 3)")
    return g, False


def _exchange(x: torch.Tensor, split_dim: int, concat_dim: int
              ) -> torch.Tensor:
    from .. import comm
    return comm.all_to_all(x, axis="expert", split_dim=split_dim,
                           concat_dim=concat_dim)


class MoE(nn.Module):
    """Mixture-of-experts block: router, dispatch, expert-parallel
    experts, combine. ``forward(x [B, S, H], train=False, generator=None)
    -> (y [B, S, H] in ``dtype``, aux f32)``; callers add ``aux`` (times
    their weight) to the task loss (reference ``MoE.forward``).

    ``params``: ``{"gate": {"kernel": [H, E]}, "experts": {...}}`` in the
    JAX layout (an ``experts`` subtree with a ``gate`` leaf makes SwiGLU
    experts with ``activation``); default :func:`init_moe_params` from
    ``seed`` on ``device`` (ExpertMLP experts of width ``hidden_size *
    mlp_ratio``, biased). ``generator`` draws top-2's Gumbel second pick
    in training (with ``noisy_gate_policy="RSample"`` or k = 2, as the
    JAX layer draws from its "gating" stream); None gates without
    noise."""

    def __init__(self, hidden_size: int, num_experts: int,
                 k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None,
                 mlp_ratio: int = 4, dtype=torch.bfloat16,
                 params: Optional[Dict[str, Any]] = None,
                 activation: str = "silu", seed: int = 0, device=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError(f"k must be 1 or 2, got {k}")
        if params is None:
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
            params = init_moe_params(hidden_size, num_experts,
                                     hidden_size * mlp_ratio, gen)
        self.hidden_size, self.num_experts, self.k = (hidden_size,
                                                      num_experts, k)
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.dtype = dtype
        self.gate = _Params(params["gate"])
        ex = params["experts"]
        self.experts = (GatedExpertMLP(ex, activation) if "gate" in ex
                        else ExpertMLP(ex))

    @property
    def tp(self):
        """This rank's ``TPContext`` when the expert kernels are its
        model-axis shards (module docstring), else None."""
        return self.experts.tp

    @tp.setter
    def tp(self, tp) -> None:
        self.experts.tp = tp

    def route(self, tokens: torch.Tensor, train: bool,
              generator: Optional[torch.Generator] = None, groups: int = 1
              ) -> Tuple[torch.Tensor, list]:
        """(aux, one :class:`Route` per group) of tokens [T, H]."""
        from ..ops.checkpoint_name import dot
        T, E = tokens.shape[0], self.num_experts
        Tg = T // groups
        logits = dot(tokens.to(torch.float32),
                     self.gate.kernel.to(torch.float32))        # [T, E]
        cf = self.capacity_factor if train else self.eval_capacity_factor
        C = compute_capacity(Tg, E, cf, self.k, self.min_capacity)
        noisy = train and (self.noisy_gate_policy == "RSample" or self.k == 2)
        gen = generator if noisy else None
        routes = [route(logits[g * Tg:(g + 1) * Tg], self.k, C, gen)
                  for g in range(groups)]
        aux = torch.stack([r.aux for r in routes]).mean()
        return aux, routes

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        B, S, H = x.shape
        E = self.num_experts
        tokens = x.reshape(B * S, H)
        T = B * S
        G, exchange = gating_groups(T)
        aux, routes = self.route(tokens, train, generator, G)
        C = routes[0].capacity
        tp = self.tp
        weight = torch.cat([r.weight for r in routes])
        if tp is not None:
            # the expert path's tokens and combine weights: their
            # gradients are rank-partial (column shards, partial outputs)
            from .. import comm
            tokens = comm.tp_copy_to(tokens, axis=tp.axis)
            weight = comm.tp_copy_to(weight, axis=tp.axis)
        queues, slots = dispatch(tokens.to(self.dtype), routes, E)
        queues = queues.view(G, E, C, H)
        if G > 1:
            queues = queues.transpose(0, 1).reshape(E, G * C, H)
        else:
            queues = queues.view(E, C, H)
        out = self._experts(queues, exchange)
        if G > 1:
            out = out.reshape(E, G, C, H).transpose(0, 1)
        y = combine(out.reshape(G * E * C, H), slots, weight, self.dtype)
        if tp is not None:
            from .. import comm
            y = comm.tp_reduce_from(y, axis=tp.axis)
        return y.reshape(B, S, H), aux.to(torch.float32)

    def _experts(self, queues: torch.Tensor, exchange: bool) -> torch.Tensor:
        """The expert MLPs over queues [E, N, H]: this process's experts,
        after the exchange over the ``expert`` group when ``exchange``."""
        E = queues.shape[0]
        El = self.experts.num_local
        if not exchange:
            if El != E:
                raise ValueError(f"{El} local experts of {E} without an "
                                 "expert group to exchange queues with")
            return self.experts(queues)
        from .. import comm
        ep = comm.axis_size("expert")
        if El * ep != E:
            raise ValueError(f"{El} local experts x expert group {ep} != "
                             f"{E} experts")
        # the comm plan's seam: a plan that routes the expert all-to-all
        # to the int8 wire runs the explicit exchange pair (the JAX layer
        # asks at trace time; the bytes are every gating group's)
        from ..comm.planned import moe_exchange_spec, planned_queue_exchange
        spec = moe_exchange_spec(queues.numel() * queues.element_size()
                                 * comm.axis_size(TOKEN_AXES))
        if spec is not None:
            algo, bits, block = spec
            dispatch_q, combine_q = planned_queue_exchange(
                algo=algo, bits=bits, block=block)
            return combine_q(self.experts(dispatch_q(queues)))
        mine = _exchange(queues, 0, 1)            # [El, ep * N, H]
        return _exchange(self.experts(mine), 1, 0)


def dispatch(tokens: torch.Tensor, routes, num_experts: int):
    """(queues [G * E * C, H], slots [T, k]) of tokens [T, H] routed per
    group (``routes``: one per T / G consecutive tokens): slot g * E * C +
    e * C + c holds the token routed to expert e at position c in group
    g, or zeros. ``slots`` names each (token, choice)'s slot, 0 for a
    dropped choice (whose combine weight is 0)."""
    T, H = tokens.shape
    G = len(routes)
    Tg, E, C = T // G, num_experts, routes[0].capacity
    n = G * E * C
    dev = tokens.device
    base = (torch.arange(G, device=dev) * (E * C)).repeat_interleave(Tg)
    expert = torch.cat([r.expert for r in routes])
    position = torch.cat([r.position for r in routes])
    keep = torch.cat([r.keep for r in routes])
    slot = base[:, None] + expert * C + position.clamp(max=C - 1)
    # the token of every slot (T: the appended zero row); dropped choices
    # all land in the spare slot n, which is cut off
    owner = torch.full((n + 1,), T, dtype=torch.long, device=dev)
    src = torch.arange(T, device=dev)[:, None].expand_as(slot)
    owner.scatter_(0, torch.where(keep, slot, n).reshape(-1),
                   src.reshape(-1))
    padded = torch.cat([tokens, tokens.new_zeros(1, H)])
    queues = padded.index_select(0, owner[:n])
    return queues, torch.where(keep, slot, 0)


def combine(out: torch.Tensor, slots: torch.Tensor, weight: torch.Tensor,
            dtype) -> torch.Tensor:
    """y [T, H] = sum_j weight[:, j] * out[slots[:, j]]: each choice's
    expert output row weighted by its combine weight (in ``dtype``, the
    JAX layer's cast), summed in f32 and returned in ``dtype``."""
    T, k = slots.shape
    rows = out.index_select(0, slots.reshape(-1)).view(T, k, -1)
    w = weight.to(dtype).to(torch.float32)
    return (w[:, :, None] * rows.to(torch.float32)).sum(dim=1).to(dtype)


def moe_reference(layer: MoE, x: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None):
    """The plain version of ``layer.forward`` in one process: the JAX
    layer's one-hot einsums over the dense combine / dispatch tensors
    (``sharded_moe.dense_from_route``), every expert local."""
    B, S, H = x.shape
    E, dt = layer.num_experts, layer.dtype
    tokens = x.reshape(B * S, H)
    G, _ = gating_groups(B * S)
    aux, routes = layer.route(tokens, train, generator, G)
    Tg = B * S // G
    dense = [dense_from_route(r, E) for r in routes]
    combine_t = torch.stack([d[1] for d in dense])              # [G,Tg,E,C]
    dispatch_t = torch.stack([d[2] for d in dense])
    tokens_g = tokens.reshape(G, Tg, H).to(dt)
    disp = torch.einsum("gtec,gth->gech", dispatch_t.to(dt), tokens_g)
    C = disp.shape[2]
    out = layer.experts(disp.transpose(0, 1).reshape(E, G * C, H))
    out_g = out.reshape(E, G, C, H).transpose(0, 1)
    y = torch.einsum("gtec,gech->gth", combine_t.to(dt).to(torch.float32),
                     out_g.to(torch.float32)).to(dt)
    return y.reshape(B, S, H), aux


def expert_parallel_apply(apply_fn: Callable, expert_params: Dict[str, Any],
                          dispatched: torch.Tensor, ep: int,
                          expert_axis: str = "expert") -> torch.Tensor:
    """The explicit GShard exchange (JAX ``expert_parallel_apply``):
    all_to_all (split E, concatenate the queue dim) -> each local expert
    -> all_to_all back.

    ``apply_fn(params_of_one_expert, x [n, H]) -> [n, H]``;
    ``expert_params``: this rank's stacked [E / ep, ...] leaves;
    ``dispatched``: this rank's [E, C, H] queue slots for every expert.
    Returns [E, C, H], this rank's slots again. ``ep`` must be the size
    of the ``expert_axis`` group."""
    from .. import comm
    E, C, H = dispatched.shape
    if E % ep != 0:
        raise ValueError(f"experts {E} not divisible by ep {ep}")
    if comm.axis_size(expert_axis) != ep:
        raise ValueError(f"ep {ep} != the {expert_axis!r} group's size "
                         f"{comm.axis_size(expert_axis)}")
    x = comm.all_to_all(dispatched, axis=expert_axis, split_dim=0,
                        concat_dim=1)                   # [El, ep * C, H]

    def one(node, i):
        if isinstance(node, dict):
            return {key: one(v, i) for key, v in node.items()}
        return node[i]

    y = torch.stack([apply_fn(one(expert_params, i), x[i])
                     for i in range(E // ep)])
    return comm.all_to_all(y, axis=expert_axis, split_dim=1, concat_dim=0)
