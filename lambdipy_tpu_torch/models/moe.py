"""Sparse Mixture-of-Experts MLP, the twin of ``lambdipy_tpu/models/moe.py``:
the Mixtral-style top-k routed SwiGLU FFN that ``models/llama.py`` builds
in place of the dense MLP when ``LlamaConfig.moe_experts > 0``.

Dense dispatch, as in JAX (GShard/Switch): tokens route within fixed-size
groups against a static per-expert capacity, as one-hot ``[g, gs, e, c]``
dispatch and combine tensors, and the expert products are plain einsums
over the ``[e, in, out]`` expert stacks. Overflow tokens are dropped (the
residual carries them). Routing is static in shape, with no ``.item()``,
no ``nonzero`` and no boolean indexing, so the port's decode and prefill
programs capture it in their CUDA graphs.

Differences from JAX, none of them numerical:

- ``top_k`` is ``k`` rounds of ``argmax`` (the first maximum, the lower
  index on a tie, as ``jax.lax.top_k``); ``torch.topk`` promises no order
  on ties.
- ``one_hot`` of a position outside ``[0, capacity)`` is a zero row in
  JAX; here the seat is a comparison against ``arange(capacity)`` under
  the keep mask, so nothing raises or syncs.
- Flax ``sow`` has no twin: :meth:`MoEMLP.forward` returns the layer's
  load-balance loss only when asked (``with_aux``), and ``LlamaModel``
  collects it only when its caller asks (``forward(..., with_aux=True)``).
  Serving computes none of it.
- No expert parallelism: the ``ep`` rules exist
  (``registry._llama_tp_rules``), and a mesh with ``ep`` above 1 raises
  (ROADMAP queue 1, item 3 (d)).

Int8 experts dequantize as JAX's do, ``w_i8.to(dtype) * scale.to(dtype)``
(a product in the model dtype), then the einsum: the int8 matmul kernel
sums in f32 and scales after, so its bits differ, and it is not used for
the experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EXPERT_KEYS = ("experts_gate", "experts_up", "experts_down")


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: ``k`` rounds of ``argmax``,
    each taking the first maximum (the lower index on a tie)."""
    e = probs.shape[-1]
    experts = torch.arange(e, device=probs.device)
    gates, idx, rest = [], [], probs
    for _ in range(k):
        i = rest.argmax(-1)
        gates.append(probs.gather(-1, i[..., None])[..., 0])
        idx.append(i)
        rest = rest.masked_fill(i[..., None] == experts, float("-inf"))
    return torch.stack(gates, -1), torch.stack(idx, -1)


def _route(probs, top_k: int, capacity: int, valid=None, aux: bool = True):
    """:func:`route_topk` over ``[..., t, e]`` probabilities (leading axes
    are routing groups); the balance loss only when ``aux``."""
    e = probs.shape[-1]
    gates, idx = _top_k(probs, top_k)  # [..., t, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(e, device=probs.device)
    onehot = (idx[..., None] == experts).float()  # [..., t, k, e]
    if valid is not None:
        onehot = onehot * valid.float()[..., None, None]

    # per slot, so the first choices of every token are seated before any
    # second choice: a token's top expert is the last to drop it
    seats = torch.arange(capacity, device=probs.device, dtype=torch.float32)
    dispatch = combine = None
    counts = torch.zeros_like(onehot[..., 0, 0, :])  # [..., e]
    for slot in range(top_k):
        oh = onehot[..., slot, :]  # [..., t, e]
        pos = oh.cumsum(-2) - 1.0 + counts[..., None, :]
        keep = (pos < capacity) & (oh > 0)
        seated = (keep[..., None] & (pos[..., None] == seats)).float()
        weighted = seated * gates[..., slot][..., None, None]
        dispatch = seated if dispatch is None else dispatch + seated
        combine = weighted if combine is None else combine + weighted
        counts = counts + oh.sum(-2)
    if not aux:
        return dispatch, combine, None

    # Switch-Transformer load-balance loss: E * <fraction of first choices
    # per expert> . <mean router probability per expert>
    w = (torch.ones_like(probs[..., 0]) if valid is None else valid.float())
    n = w.sum(-1).clamp(min=1.0)[..., None]
    frac_tokens = onehot[..., 0, :].sum(-2) / n
    mean_probs = (probs * w[..., None]).sum(-2) / n
    return dispatch, combine, e * (frac_tokens * mean_probs).sum(-1)


def route_topk(probs, top_k: int, capacity: int, valid=None):
    """GShard-style top-k routing with a static per-expert capacity (JAX
    ``moe.py:33-75``). ``probs``: ``[t, e]`` f32 router probabilities, or
    ``[g, t, e]`` for ``g`` routing groups at once. Returns ``(dispatch
    [..., t, e, c] {0, 1}, combine [..., t, e, c] f32, aux_loss [...])``.
    ``valid``: optional ``[..., t]`` bool; invalid (padding) tokens are
    never seated and are left out of the balance loss."""
    return _route(probs, top_k, capacity, valid, aux=True)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts (JAX ``moe.py:78-165``). Parameters
    keep JAX's names and layouts: ``router`` ``[hidden, e]`` f32, and
    ``experts_gate`` / ``experts_up`` ``[e, hidden, mlp]``,
    ``experts_down`` ``[e, mlp, hidden]`` in ``dtype``; with
    ``quant="int8"`` each stack is ``<name>_int8`` plus a per-(expert,
    output channel) f32 ``<name>_scale`` ``[e, 1, out]``. Buffers: the
    port serves, it does not train."""

    def __init__(self, hidden: int, num_experts: int, mlp: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, quant: str | None = None,
                 group_size: int = 256, device=None):
        super().__init__()
        self.hidden, self.num_experts, self.mlp = hidden, num_experts, mlp
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.dtype, self.quant, self.group_size = dtype, quant, group_size
        self.register_buffer("router", torch.empty(
            hidden, num_experts, dtype=torch.float32, device=device))
        shapes = {"experts_gate": (hidden, mlp), "experts_up": (hidden, mlp),
                  "experts_down": (mlp, hidden)}
        for name, (n_in, n_out) in shapes.items():
            if quant == "int8":
                self.register_buffer(f"{name}_int8", torch.empty(
                    num_experts, n_in, n_out, dtype=torch.int8,
                    device=device))
                self.register_buffer(f"{name}_scale", torch.empty(
                    num_experts, 1, n_out, dtype=torch.float32,
                    device=device))
            else:
                self.register_buffer(name, torch.empty(
                    num_experts, n_in, n_out, dtype=dtype, device=device))

    def expert_weight(self, name: str):
        """An expert stack in the model dtype: int8 dequantized per call
        as JAX's ``_expert_weight`` does (a product in ``dtype``)."""
        if self.quant == "int8":
            return (getattr(self, f"{name}_int8").to(self.dtype)
                    * getattr(self, f"{name}_scale").to(self.dtype))
        return getattr(self, name)

    def capacity(self, tokens: int) -> tuple[int, int, int]:
        """``(group size, groups, per-expert capacity)`` for ``tokens``
        tokens, in Python's arithmetic as JAX's (``moe.py:121-126``)."""
        gs = min(tokens, self.group_size)
        g = -(-tokens // gs)
        cap = max(1, int(self.capacity_factor * self.top_k * gs
                         / self.num_experts))
        return gs, g, cap

    def route(self, x, aux: bool = False):
        """``x [b, s, hidden]`` -> ``(dispatch, combine, layer aux or
        None)`` over ``[g, gs, e, c]``, padding tokens invalid."""
        b, s, hidden = x.shape
        t = b * s
        gs, g, cap = self.capacity(t)
        pad = g * gs - t
        probs = torch.softmax(x.reshape(t, hidden).float() @ self.router, -1)
        valid = torch.ones(t, dtype=torch.bool, device=x.device)
        if pad:
            probs = F.pad(probs, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
        vg = valid.reshape(g, gs)
        dispatch, combine, group_aux = _route(
            probs.reshape(g, gs, self.num_experts), self.top_k, cap,
            valid=vg, aux=aux)
        if not aux:
            return dispatch, combine, None
        # per-group losses weighted by their valid tokens: a mostly-padding
        # tail group must not weigh as much as a full one
        n_g = vg.float().sum(-1)
        return dispatch, combine, ((group_aux * n_g).sum()
                                   / n_g.sum().clamp(min=1.0))

    def forward(self, x, with_aux: bool = False):
        """``x [b, s, hidden]`` -> ``[b, s, hidden]`` in ``x``'s dtype;
        ``(out, aux)`` with the layer's balance loss when ``with_aux``."""
        b, s, hidden = x.shape
        t = b * s
        dispatch, combine, aux = self.route(x, aux=with_aux)
        g, gs = dispatch.shape[:2]
        tokens = x.reshape(t, hidden)
        if g * gs > t:
            tokens = F.pad(tokens, (0, 0, 0, g * gs - t))
        dt = self.dtype
        xe = torch.einsum("gtec,gth->gech", dispatch.to(dt),
                          tokens.reshape(g, gs, hidden).to(dt))
        gate = torch.einsum("gech,ehm->gecm", xe,
                            self.expert_weight("experts_gate"))
        up = torch.einsum("gech,ehm->gecm", xe,
                          self.expert_weight("experts_up"))
        ye = torch.einsum("gecm,emh->gech", F.silu(gate) * up,
                          self.expert_weight("experts_down"))
        out = torch.einsum("gtec,gech->gth", combine.to(dt), ye)
        out = out.reshape(g * gs, hidden)[:t].reshape(b, s, hidden).to(x.dtype)
        return (out, aux) if with_aux else out


def moe_aux_loss(losses) -> torch.Tensor:
    """The sum of the layers' balance losses (JAX ``moe.py:168-175`` sums
    every sown ``moe_aux_loss``): ``losses`` is what ``LlamaModel.forward
    (..., with_aux=True)`` collected, one scalar per MoE layer."""
    total = torch.zeros((), dtype=torch.float32)
    for v in losses:
        v = torch.as_tensor(v)
        total = total.to(v.device) + v.sum()
    return total
