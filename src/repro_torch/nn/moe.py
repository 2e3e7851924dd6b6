"""Mixture-of-Experts feed-forward with capacity-bound top-k routing
(``repro/nn/moe.py``).

* The experts are stacked: ``w_gate``/``w_in`` (E, D, F), ``w_out`` (E, F,
  D).  Under weight-only serving each is an int8 :class:`QTensor` with one
  exponent per (expert, column); the products are batched matmuls over the
  dequantized stack, as the reference's ``einsum``s are (no Pallas kernel
  computes them there either).
* The router (``kind="router"``) stays float32, and so does its softmax;
  the choice of experts is made on the probabilities rounded to bf16, as
  the reference makes it, so ties are frequent.  Both top-k selections
  (experts per token, tokens per expert) take the lower index first on a
  tie, as ``jax.lax.top_k`` does: a stable descending sort, never
  ``torch.topk``.
* Dispatch is dense and static-shaped: the batch's tokens form routing
  groups of contiguous rows (``num_groups``, by default the mesh's data
  degree: one group without a mesh, and under one each data rank routes
  its own rows), each expert takes its top-``capacity`` tokens of a group
  by gate, runs its gated MLP over them, and the gate-weighted outputs are
  added back to their tokens.  Tokens past an expert's capacity are
  dropped (GShard/Switch), so every row of a group competes for capacity:
  inactive slots and pad rows included.
* The Switch load-balance loss, the mean over groups of ``E * sum_e f_e *
  P_e``, goes to the context's auxiliary losses; kimi-k2's shared expert
  (a ``GatedMLP`` of width ``d_ff * n_shared_experts``) runs on every
  token.
* Under a mesh the expert stacks are expert-parallel: E cut over
  ``model``, gathered over ``data`` in training (FSDP on the last dim).
  Each ``model`` rank runs its block of experts on the dispatched tokens
  and the outputs are gathered over the expert dim.  A decode step (one
  position) under a mesh is weight-stationary (serving specs: E over
  ``model``, the contracting dim D of ``w_gate``/``w_in`` and F of
  ``w_out`` over ``data``): the batch's tokens are gathered over ``data``
  and routed as one group, each rank multiplies its slice of the
  contracting dim, two sums over ``data`` complete the products, and each
  rank keeps its own rows.  A serving forward whose tokens one data rank
  owns or that mixes every rank's (a chunk, a one-shot prompt, a ragged
  tick: ``Context.rows``) takes the same dispatch over the one device's
  tokens, picked from the gathered ones, so every rank routes them as the
  one device does and the sums add slices of the same products.

The softmax is the reference's step for step: ``exp(x - max)`` with XLA's
CPU exponential (:func:`exp_f32`) over a left-to-right row sum, so the bf16
probabilities the routing compares are the reference's bit for bit at the
widths the tests hold it to (E = 4 and 16).  At kimi-k2's E = 384 XLA sums
a row in another order, and a left-to-right sum matches it in few rows.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import QMode
from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.dist import shard_ops
from repro_torch.nn.layers import (Dense, _fq_in, _fq_out, _fq_weight, fq_weight_mesh, lecun_normal,
                                   mesh_split)
from repro_torch.nn.mlp import ACTIVATIONS, GatedMLP
from repro_torch.nn.module import Context, Params

# every MoE the reference builds takes these: Switch's capacity factor and
# the weight of its load-balance loss
_CAPACITY_FACTOR = 1.25
_AUX_LOSS_WEIGHT = 0.01


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return struct.unpack("f", struct.pack("f", v))[0]


# XLA's CPU exponential (a Cephes polynomial on x - n log 2, its
# multiply-adds fused); its constants are float32 values
_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64, and the sum rounds there before the float32 rounding."""
    return (a.double() * b + c).float()


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` step for step as XLA's CPU backend computes it: n =
    floor(x log2 e + 1/2) clamped to [-127, 127], r = x - n ln 2 in two
    fused steps, e^r from a degree-6 polynomial of fused multiply-adds, times
    2^n.  ``torch.exp`` differs from it in about one value in ten, by an ulp:
    enough to move a bf16-rounded routing probability across a tie."""
    x = torch.clamp(x.to(torch.float32), -87.8, 88.8)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_LN2_HI, x)
    r = _fma(n, -_LN2_LO, r)
    z = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = _fma(z, r, c)
    z = _fma(z, r * r, r) + 1.0
    return z * torch.exp2(n)


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis as XLA's CPU backend computes it
    for rows of up to 16 experts: ``exp_f32(x - max)`` over its row sum taken
    left to right (one add per expert)."""
    e = exp_f32(logits - torch.amax(logits, dim=-1, keepdim=True))
    total = e[..., 0]
    for i in range(1, e.shape[-1]):
        total = total + e[..., i]
    return e / total[..., None]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The int64 indices of the ``k`` largest entries along the last axis,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@dataclasses.dataclass(frozen=True)
class MoE:
    """Top-k routed stacked expert MLPs with a load-balance auxiliary loss."""

    d_model: int
    d_ff: int                      # each expert's hidden width
    n_experts: int
    top_k: int
    n_shared_experts: int = 0      # kimi-k2: always-on shared expert(s)
    activation: str = "silu"
    name: str = "moe"

    def _router(self) -> Dense:
        return Dense(self.d_model, self.n_experts, use_bias=False, name="router",
                     kind="router")

    def _shared(self) -> GatedMLP:
        return GatedMLP(self.d_model, self.d_ff * self.n_shared_experts,
                        activation=self.activation, name="shared")

    def init(self, gen: torch.Generator, device) -> Params:
        e, d, f = self.n_experts, self.d_model, self.d_ff
        p: Params = {
            "router": self._router().init(gen, device),
            "experts": {"w_gate": {"kernel": lecun_normal(gen, (e, d, f), device)},
                        "w_in": {"kernel": lecun_normal(gen, (e, d, f), device)},
                        "w_out": {"kernel": lecun_normal(gen, (e, f, d), device)}},
        }
        if self.n_shared_experts:
            p["shared"] = self._shared().init(gen, device)
        return p

    def capacity(self, tokens: int) -> int:
        """Tokens an expert takes from a batch of ``tokens``:
        ceil(tokens * K / E * _CAPACITY_FACTOR), within [1, tokens]."""
        cap = math.ceil(tokens * self.top_k / self.n_experts * _CAPACITY_FACTOR)
        return max(1, min(cap, tokens))

    def route(self, probs_sel: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routing decision of one group over bf16 probabilities (t, E):
        each token's top-K experts (t, K), then each expert's top-``cap``
        tokens by gate (E, cap), lower indices first on ties."""
        top_idx = top_k_indices(probs_sel, self.top_k)
        gates = probs_sel * _expert_mask(top_idx, self.n_experts, probs_sel.dtype)
        return top_idx, top_k_indices(gates.T, cap)

    def _shape(self, name: str) -> Tuple[int, int, int]:
        e, d, f = self.n_experts, self.d_model, self.d_ff
        return (e, f, d) if name == "w_out" else (e, d, f)

    def _expert_w(self, params: Params, name: str, ctx: Context,
                  stationary: bool = False) -> torch.Tensor:
        """One stacked expert weight as float32: int8 codes times their
        scales (a float32 transient of the whole stack), fake-quantized
        under QAT and PTQ evaluation, or the float leaf.  An expert stack's
        exponents are broadcast-shaped, one per (expert, column), so the
        codes multiply their scales directly: one pass, where
        ``QTensor.dequantize`` casts first and then multiplies (two passes;
        1.84 against 2.57 ms a phi3.5-moe stack on an H100).  Under a mesh
        the stack arrives as this rank's block of experts; in training its
        last dim is gathered over ``data`` (the weight-stationary decode
        keeps its slice of the contracting dim)."""
        leaf = params["experts"][name]["kernel"]
        if isinstance(leaf, PackedQTensor):
            raise ValueError("MoE experts take int8 weights: packed sub-int8 expert stacks "
                             "are not served (the reference fails on them)")
        split = {}
        if ctx.mesh is not None:
            local, full = (leaf.q if isinstance(leaf, QTensor) else leaf).shape[-3:], \
                self._shape(name)
            split[-3] = mesh_split(local[0], full[0], ctx, "expert")
            for dim in (-2, -1):
                ax = mesh_split(local[dim], full[dim], ctx, "fsdp")
                if not ax or stationary:
                    continue
                if isinstance(leaf, QTensor):
                    n = leaf.n
                    if n.shape[dim] == local[dim] > 1:
                        n = shard_ops.all_gather(n, dim, ctx.mesh, ax)
                    leaf = QTensor(shard_ops.all_gather(leaf.q, dim, ctx.mesh, ax), n,
                                   leaf.width)
                else:
                    leaf = shard_ops.gather_fsdp(leaf, dim, ctx.mesh, ax)
        if isinstance(leaf, QTensor):
            return leaf.q * leaf.scale
        if ctx.policy.enabled and ctx.policy.mode not in (QMode.INTEGER, QMode.CALIB):
            if split:
                return fq_weight_mesh(leaf, ctx.scope(name), split)
            return _fq_weight(leaf, ctx.scope(name), channel_axis=-1)
        return leaf

    def _expert_block(self, ctx: Context, local_e: int) -> Tuple[Optional[str], int, int]:
        """(the axis cutting the experts, this rank's first expert, how many)."""
        axis = mesh_split(local_e, self.n_experts, ctx, "expert") if ctx.mesh is not None \
            else None
        lo = shard_ops.axis_index(ctx.mesh, axis) * local_e if axis else 0
        return axis, lo, local_e

    def _local_e(self, params: Params) -> int:
        leaf = params["experts"]["w_gate"]["kernel"]
        return (leaf.q if isinstance(leaf, QTensor) else leaf).shape[-3]

    def experts(self, params: Params, xe: torch.Tensor, ctx: Context) -> torch.Tensor:
        """The experts' gated MLPs over their dispatched tokens, (E, C, D)
        -> (E, C, D): batched products over the float32 stacks, between the
        ``experts/in`` and ``experts/out`` fake-quant sites.  Under a mesh
        this rank runs its block of experts (``copy_in`` sums the tokens'
        gradient over ``model``) and the outputs are gathered over
        ``model``."""
        xe = _fq_in(xe, ctx, "experts/in")
        axis, lo, n = self._expert_block(ctx, self._local_e(params))
        if axis:
            xe = shard_ops.copy_in(xe, ctx.mesh, axis)[lo:lo + n]
        h = ACTIVATIONS[self.activation](
            torch.bmm(xe, self._expert_w(params, "w_gate", ctx))) \
            * torch.bmm(xe, self._expert_w(params, "w_in", ctx))
        ye = torch.bmm(h, self._expert_w(params, "w_out", ctx))
        if axis:
            ye = shard_ops.gather_replicated(ye, 0, ctx.mesh, axis)
        return _fq_out(ye, ctx, "experts/out")

    def _stationary_experts(self, params: Params, xe: torch.Tensor, ctx: Context):
        """The weight-stationary decode's experts over the whole batch's
        dispatched tokens (E, C, D): this rank's experts times its slices
        of the contracting dims, each product completed by a sum over
        ``data`` (``w_gate`` and ``w_in`` in one), gathered over
        ``model``."""
        mesh = ctx.mesh
        xe = _fq_in(xe, ctx, "experts/in")
        axis, lo, n = self._expert_block(ctx, self._local_e(params))
        wg, wi = (self._expert_w(params, k, ctx, stationary=True) for k in ("w_gate", "w_in"))
        wo = self._expert_w(params, "w_out", ctx, stationary=True)
        xl = xe[lo:lo + n]
        d_ax = mesh_split(wg.shape[-2], self.d_model, ctx, "fsdp")
        if d_ax:
            xl = shard_ops.own_block(xl, -1, mesh, d_ax)
            gi = shard_ops.psum(torch.stack([torch.bmm(xl, wg), torch.bmm(xl, wi)]), mesh, d_ax)
        else:
            gi = torch.stack([torch.bmm(xl, wg), torch.bmm(xl, wi)])
        h = ACTIVATIONS[self.activation](gi[0]) * gi[1]
        f_ax = mesh_split(wo.shape[-2], self.d_ff, ctx, "fsdp")
        if f_ax:
            ye = shard_ops.psum(torch.bmm(shard_ops.own_block(h, -1, mesh, f_ax), wo), mesh, f_ax)
        else:
            ye = torch.bmm(h, wo)
        if axis:
            ye = shard_ops.all_gather(ye, 0, mesh, axis)
        return _fq_out(ye, ctx, "experts/out")

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              num_groups: Optional[int] = None) -> torch.Tensor:
        """x (B, S, D) -> (B, S, D); under a mesh B is this rank's rows.

        Under a mesh a decode step (S = 1) and a forward with
        ``ctx.rows`` (a chunk, a one-shot prompt or a ragged tick, whose
        tokens are the one device's batch as :class:`~repro_torch.nn.module.
        DataRows` says) take the weight-stationary dispatch: every rank
        routes the one-device tokens (gathered over ``data``, then picked by
        ``rows.select``) as the one device groups them, and keeps its own
        rows of the output (its block, or ``rows.take``)."""
        ctx = ctx.scope(self.name)
        b, s, d = x.shape
        e = self.n_experts
        stationary = ctx.mesh is not None and (s == 1 or ctx.rows is not None)
        rows_ax = ctx.rule("batch") if ctx.mesh is not None else None
        dp = shard_ops.axis_size(ctx.mesh, rows_ax) if rows_ax else 1
        x_rows = x
        if stationary:
            x = x.reshape(b * s, d)
            if dp > 1:
                x = shard_ops.all_gather(x, 0, ctx.mesh, rows_ax)  # every rank's tokens
            if ctx.rows is not None:
                x = x[ctx.rows.select]
            b_all = 1 if ctx.rows is not None else b * dp          # the one device's rows
        else:
            b_all = b * dp
        if num_groups is None:
            num_groups = 1 if stationary else ctx.dp_size
        g = max(1, min(num_groups, b_all))
        while b_all % g:
            g -= 1
        if not stationary and g % dp:
            raise ValueError(f"{g} routing groups over {dp} data ranks")
        g = g if stationary else g // dp                           # this rank's groups
        t = x.shape[0] // g if stationary else b // g * s
        xt = x.reshape(g, t, d).to(torch.float32)
        probs = softmax_f32(self._router().apply(params["router"], xt, ctx))      # (g, t, E)
        probs_sel = probs.to(torch.bfloat16)
        routes = [self.route(probs_sel[i], self.capacity(t)) for i in range(g)]
        top_idx = torch.stack([r[0] for r in routes])                            # (g, t, K)
        sel_idx = torch.stack([r[1] for r in routes])                            # (g, E, C)
        mask = _expert_mask(top_idx, e, torch.bfloat16)                          # (g, t, E)

        # Switch load balance: E * sum_e f_e * P_e, f_e in bf16 as the mask is
        aux = torch.mean(torch.sum(torch.mean(mask, dim=1) * torch.mean(probs, dim=1), dim=-1)) * e
        ctx.add_loss("moe_load_balance", _AUX_LOSS_WEIGHT * aux)

        sel_gate = torch.gather((probs_sel * mask).transpose(1, 2), 2, sel_idx)    # (g, E, C)
        cap = sel_idx.shape[-1]
        if g == 1:
            xe = xt[0][sel_idx[0]]                                                # (E, C, D)
        else:   # the groups' tokens side by side: (E, g * C, D)
            xe = torch.stack([xt[i][sel_idx[i]] for i in range(g)], 1).reshape(e, g * cap, d)
        ye = (self._stationary_experts if stationary else self.experts)(params, xe, ctx)
        ye = ye.reshape(e, g, cap, d).transpose(0, 1) \
            * sel_gate[..., None].to(torch.float32)                               # (g, E, C, D)
        # combine: each token's gate-weighted outputs added back to its row
        rows = (sel_idx + t * torch.arange(g, device=x.device)[:, None, None]).reshape(-1)
        out = torch.zeros(g * t, d, dtype=ye.dtype, device=x.device).index_add(
            0, rows, ye.reshape(-1, d))
        if stationary and ctx.rows is not None:
            out = out[ctx.rows.take]
        elif stationary and dp > 1:
            out = shard_ops.own_block(out, 0, ctx.mesh, rows_ax)
        out = out.reshape(x_rows.shape)
        if self.n_shared_experts:
            out = out + self._shared().apply(params["shared"], x_rows, ctx)
        return out


def _expert_mask(top_idx: torch.Tensor, n_experts: int, dtype) -> torch.Tensor:
    """(..., t, K) expert choices -> the (..., t, E) 0/1 mask of chosen experts."""
    return F.one_hot(top_idx, n_experts).sum(dim=-2).to(dtype)
