"""State-space sequence mixers (``repro/nn/ssm.py``): Mamba and RWKV-6
"Finch" time-mix, and the RWKV-6 channel-mix FFN.

Both mixers are attention-free recurrences with a fixed-size decode state.
Every projection is a :class:`Dense` (the ``wq_matmul`` / ``wq4_matmul``
kernels under weight-only quantization) except Mamba's ``dt_proj``, which
the weight-only conversion keeps float, as the reference does.  The
recurrent state itself stays float32: a Qm.n state would re-quantize every
step and its truncation error would compound.  The recurrences are plain
PyTorch, as they are plain jnp in the reference: the prefill scan walks its
positions one by one (in chunks of ``chunk`` positions, which bound the
materialized (B, chunk, ...) tensors), and decode is one recurrence step
against the carried state.

Each ``apply(params, x, ctx, state=None, chunk=None)`` returns ``(y,
new_state)``:
* ``state=None``: a forward from zero state (training, scoring); no state
  comes back;
* ``state`` given: a prefill (S > 1) or decode step (S == 1) of every batch
  row from its carried state; the new state comes back;
* ``chunk=KVChunk(slot, start, length)``: x is one (1, S, D) prompt chunk
  of serving slot ``slot``: that slot's state row is read, advanced over the
  ``length`` live positions (the pad tail is an exact identity update) and
  written back into a copy of the whole state.
The state is never written in place, so a batched step's previous state
stays intact for the scheduler's inactive-slot merge
(``serve/slot_state.py`` ``merge_inactive``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.qformat import QTensor
from repro_torch.nn.attention import KVChunk
from repro_torch.nn.layers import Dense, lecun_normal, normal_init
from repro_torch.nn.module import Context, Params

State = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _row(state: torch.Tensor, slot: int) -> torch.Tensor:
    return state[slot:slot + 1]


def _put_row(state: torch.Tensor, slot: int, row: torch.Tensor) -> torch.Tensor:
    """A copy of ``state`` with batch row ``slot`` replaced by ``row``."""
    out = state.clone()
    out[slot:slot + 1] = row.to(state.dtype)
    return out


def _live(s: int, length: int, ndim: int, device) -> torch.Tensor:
    """(1, S, 1, ...) bool: the chunk's first ``length`` positions."""
    live = torch.arange(s, device=device) < length
    return live.reshape((1, s) + (1,) * (ndim - 2))


# --------------------------------------------------------------------------
# Mamba (selective SSM, v1)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba:
    """Mamba selective-SSM mixer with a recurrent decode state
    ``{"h": (B, d_inner, d_state), "conv": (B, d_conv - 1, d_inner)}``."""

    d_model: int
    d_inner: int = 0          # default 2 * d_model
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0          # default ceil(d_model / 16)
    chunk: int = 128
    name: str = "mamba"

    @property
    def _di(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def _dtr(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    def _projs(self):
        di = self._di
        return {"in_proj": Dense(self.d_model, 2 * di, use_bias=False, name="in_proj"),
                "x_proj": Dense(di, self._dtr + 2 * self.d_state, use_bias=False,
                                name="x_proj"),
                "dt_proj": Dense(self._dtr, di, use_bias=True, name="dt_proj"),
                "out_proj": Dense(di, self.d_model, use_bias=False, name="out_proj")}

    def init(self, gen: torch.Generator, device) -> Params:
        di, n = self._di, self.d_state
        p: Params = {nm: layer.init(gen, device) for nm, layer in self._projs().items()}
        # depthwise causal conv over time, (K, 1, d_inner) as the reference stores it
        p["conv"] = {"kernel": lecun_normal(gen, (self.d_conv, 1, di), device),
                     "bias": torch.zeros(di, dtype=torch.float32, device=device)}
        # S4D-real init for A; D skip
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None, :].repeat(di, 1)
        p["ssm"] = {"a_log": torch.log(a),
                    "d_skip": torch.ones(di, dtype=torch.float32, device=device)}
        return p

    def _conv1d(self, params: Params, x: torch.Tensor,
                conv_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal depthwise conv over (B, S, d_inner); returns (y, xp), xp the
        left-padded input (``conv_state``, the previous K-1 inputs, or zeros
        in front).  A cross-correlation over the taps, as
        ``lax.conv_general_dilated`` computes it; a weight-only int8 kernel
        (a :class:`QTensor`, one scale per (tap, channel)) is dequantized."""
        w = params["conv"]["kernel"]
        if isinstance(w, QTensor):
            w = w.dequantize()
        k, s = self.d_conv, x.shape[1]
        if conv_state is not None:
            xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
        else:
            xp = F.pad(x, (0, 0, k - 1, 0))
        y = xp[:, 0:s] * w[0, 0]
        for tap in range(1, k):
            y = y + xp[:, tap:tap + s] * w[tap, 0]
        return y + params["conv"]["bias"], xp

    def _ssm_inputs(self, params: Params, xc: torch.Tensor, ctx: Context):
        """Data-dependent dt, B, C from the conv output."""
        projs = self._projs()
        dbc = projs["x_proj"].apply(params["x_proj"], xc, ctx)
        dtr, n = self._dtr, self.d_state
        dt, bmat, cmat = dbc[..., :dtr], dbc[..., dtr:dtr + n], dbc[..., dtr + n:]
        dt = softplus(projs["dt_proj"].apply(params["dt_proj"], dt, ctx).to(torch.float32))
        return dt, bmat.to(torch.float32), cmat.to(torch.float32)

    def _scan(self, a_log, d_skip, xc, dt, bmat, cmat, h0):
        """Selective scan over (B, L, ·) inputs from h0 (B, d_inner, N):
        returns (y (B, L, d_inner), h_L).  Chunks of ``chunk`` positions
        bound the materialized (B, chunk, d_inner, N) decays."""
        length = xc.shape[1]
        A = -torch.exp(a_log)                                       # (di, N)
        xcf = xc.to(torch.float32)
        h, ys = h0, []
        for c0 in range(0, length, self.chunk):
            sl = slice(c0, min(c0 + self.chunk, length))
            dtk = dt[:, sl]
            da = torch.exp(dtk[..., None] * A)                      # (B, ch, di, N)
            dbx = (dtk * xcf[:, sl])[..., None] * bmat[:, sl, None, :]
            ck = cmat[:, sl]
            for t in range(da.shape[1]):
                h = da[:, t] * h + dbx[:, t]
                ys.append(torch.einsum("bdn,bn->bd", h, ck[:, t]))
        return torch.stack(ys, dim=1) + xcf * d_skip, h

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              state: Optional[State] = None, chunk: Optional[KVChunk] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
        """x (B, S, D); ``state`` {'h': (B, d_inner, N) f32, 'conv': (B, K-1,
        d_inner)} or None.  With ``chunk``, the pad tail is masked to dt = 0
        (da = 1, dbx = 0: an identity update), so the state lands exactly at
        position ``length``."""
        ctx = ctx.scope(self.name)
        projs = self._projs()
        b, s, _ = x.shape
        di, k = self._di, self.d_conv
        xz = projs["in_proj"].apply(params["in_proj"], x, ctx)
        xin, z = xz[..., :di], xz[..., di:]

        decode = state is not None and chunk is None
        if chunk is not None:
            h0, conv_state = _row(state["h"], chunk.slot), _row(state["conv"], chunk.slot)
        else:
            h0 = state["h"] if decode else torch.zeros(b, di, self.d_state,
                                                      dtype=torch.float32, device=x.device)
            conv_state = state["conv"] if decode else None
        xc, xp = self._conv1d(params, xin, conv_state)
        xc = F.silu(xc)

        dt, bmat, cmat = self._ssm_inputs(params, xc, ctx)
        if chunk is not None:
            dt = torch.where(_live(s, chunk.length, 3, x.device), dt, 0.0)

        if decode and s == 1:
            A = -torch.exp(params["ssm"]["a_log"])
            da = torch.exp(dt[:, 0, :, None] * A)
            h = da * h0 + (dt[:, 0] * xc[:, 0].to(torch.float32))[..., None] * bmat[:, 0, None, :]
            y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
            y = y + xc.to(torch.float32) * params["ssm"]["d_skip"]
        else:
            y, h = self._scan(params["ssm"]["a_log"], params["ssm"]["d_skip"], xc, dt, bmat,
                              cmat, h0)

        out = projs["out_proj"].apply(params["out_proj"], y * F.silu(z), ctx)
        if chunk is not None:
            # the conv carry: the K-1 inputs ending at the live length (xp is
            # the carry-prepended input, so row ``length`` is its first row)
            carry = xp[:, chunk.length:chunk.length + k - 1]
            new_state = {"h": _put_row(state["h"], chunk.slot, h),
                         "conv": _put_row(state["conv"], chunk.slot, carry) if k > 1
                         else state["conv"]}
        elif decode:
            new_state = {"h": h, "conv": xp[:, xp.shape[1] - (k - 1):] if k > 1 else None}
        else:
            new_state = None
        return out, new_state

    def init_state(self, batch: int, device, layers: Optional[int] = None) -> State:
        """Zeroed per-slot state; ``layers`` puts a stacked layer axis in front."""
        lead = (batch,) if layers is None else (layers, batch)
        return {"h": torch.zeros(*lead, self._di, self.d_state, dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros(*lead, self.d_conv - 1, self._di, dtype=torch.float32,
                                    device=device)}


# --------------------------------------------------------------------------
# RWKV-6 "Finch": data-dependent decay linear attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKV6TimeMix:
    """RWKV-6 time-mixing: S_t = diag(w_t) S_{t-1} + k^T v,
    o = r (S_{t-1} + diag(u) k^T v), with a data-dependent per-channel decay
    w_t through a low-rank MLP, token-shift interpolation of the inputs and
    per-head (N x N) float32 state ``{"s": (B, H, N, N), "shift": (B, 1, D)}``."""

    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128
    name: str = "timemix"

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    def _projs(self):
        d = self.d_model
        return {nm: Dense(d, d, use_bias=False, name=nm) for nm in ("wr", "wk", "wv", "wg", "wo")}

    def init(self, gen: torch.Generator, device) -> Params:
        d, h, n = self.d_model, self.n_heads, self.head_dim
        p: Params = {nm: layer.init(gen, device) for nm, layer in self._projs().items()}
        p["decay"] = {   # w0 + tanh(x A) B, the Finch decay LoRA
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
            "a": normal_init(gen, (d, self.decay_lora), device, std=0.01),
            "b": normal_init(gen, (self.decay_lora, d), device, std=0.01)}
        p["bonus_u"] = normal_init(gen, (h, n), device, std=0.5)
        p["mix"] = {"x": torch.full((5, d), 0.5, dtype=torch.float32, device=device)}
        p["ln_out"] = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
        return p

    def _scan(self, r, k, v, w, u, s0):
        """The recurrence over (B, L, H, N) r/k/v and decay w in (0, 1) from
        s0 (B, H, N, N); returns (out (B, L, H, N), s_L)."""
        s, outs = s0, []
        for c0 in range(0, r.shape[1], self.chunk):
            sl = slice(c0, min(c0 + self.chunk, r.shape[1]))
            rk, kk, vk, wk = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
            for t in range(rk.shape[1]):
                kv = kk[:, t, :, :, None] * vk[:, t, :, None, :]          # (B, H, N, N)
                outs.append(torch.einsum("bhn,bhnm->bhm", rk[:, t],
                                         s + u[None, :, :, None] * kv))
                s = wk[:, t, :, :, None] * s + kv
        return torch.stack(outs, dim=1), s

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              state: Optional[State] = None, chunk: Optional[KVChunk] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
        """The WKV recurrence over x (B, S, D).  With ``chunk``, the pad tail
        is an identity update (decay 1, k = 0) and the slot's shift carry is
        row ``length - 1``."""
        ctx = ctx.scope(self.name)
        projs = self._projs()
        b, s, d = x.shape
        h, n = self.n_heads, self.head_dim
        if chunk is not None:
            last, s0 = _row(state["shift"], chunk.slot), _row(state["s"], chunk.slot)
        else:
            last = state["shift"] if state is not None else x.new_zeros(b, 1, d)
            s0 = state["s"] if state is not None else torch.zeros(
                b, h, n, n, dtype=torch.float32, device=x.device)
        prev = torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)
        mix = params["mix"]["x"]
        xr, xk, xv, xg, xw = (x + mix[i] * (prev - x) for i in range(5))

        r = projs["wr"].apply(params["wr"], xr, ctx).reshape(b, s, h, n)
        k = projs["wk"].apply(params["wk"], xk, ctx).reshape(b, s, h, n)
        v = projs["wv"].apply(params["wv"], xv, ctx).reshape(b, s, h, n)
        g = F.silu(projs["wg"].apply(params["wg"], xg, ctx))

        # data-dependent decay, float32 (the "decay" leaves stay float)
        dk = params["decay"]
        wraw = dk["w0"] + torch.matmul(torch.tanh(torch.matmul(xw.to(torch.float32), dk["a"])),
                                       dk["b"])
        w = torch.exp(-torch.exp(wraw)).reshape(b, s, h, n)           # (0, 1)

        r32, k32, v32 = (t.to(torch.float32) for t in (r, k, v))
        if chunk is not None:
            live = _live(s, chunk.length, 4, x.device)
            w = torch.where(live, w, 1.0)
            k32 = torch.where(live, k32, 0.0)

        if state is not None and chunk is None and s == 1:
            kv = k32[:, 0, :, :, None] * v32[:, 0, :, None, :]
            o = torch.einsum("bhn,bhnm->bhm", r32[:, 0],
                             s0 + params["bonus_u"][None, :, :, None] * kv)
            s_t = w[:, 0, :, :, None] * s0 + kv
            out = o[:, None]
        else:
            out, s_t = self._scan(r32, k32, v32, w, params["bonus_u"], s0)

        # per-head group norm (ln_out: the population variance), gate, project
        mu = torch.mean(out, dim=-1, keepdim=True)
        var = torch.mean(torch.square(out - mu), dim=-1, keepdim=True)
        out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d) * params["ln_out"]["scale"]
        y = projs["wo"].apply(params["wo"], out * g, ctx)
        if chunk is not None:
            tail = x[:, chunk.length - 1:chunk.length]
            new_state = {"s": _put_row(state["s"], chunk.slot, s_t),
                         "shift": _put_row(state["shift"], chunk.slot, tail)}
        elif state is not None:
            new_state = {"s": s_t, "shift": x[:, -1:]}
        else:
            new_state = None
        return y, new_state

    def init_state(self, batch: int, device, layers: Optional[int] = None) -> State:
        """Zeroed per-slot state; ``layers`` puts a stacked layer axis in front."""
        lead = (batch,) if layers is None else (layers, batch)
        n = self.head_dim
        return {"s": torch.zeros(*lead, self.n_heads, n, n, dtype=torch.float32, device=device),
                "shift": torch.zeros(*lead, 1, self.d_model, dtype=torch.float32,
                                     device=device)}


@dataclasses.dataclass(frozen=True)
class RWKV6ChannelMix:
    """RWKV-6 channel-mixing FFN: relu(wk(x~))^2 wv gated by sigmoid(wr(x~)),
    with a token-shift state ``{"shift": (B, 1, D)}``."""

    d_model: int
    d_ff: int
    name: str = "chanmix"

    def _projs(self):
        return {"wk": Dense(self.d_model, self.d_ff, use_bias=False, name="wk"),
                "wv": Dense(self.d_ff, self.d_model, use_bias=False, name="wv"),
                "wr": Dense(self.d_model, self.d_model, use_bias=False, name="wr")}

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {nm: layer.init(gen, device) for nm, layer in self._projs().items()}
        p["mix"] = {"x": torch.full((2, self.d_model), 0.5, dtype=torch.float32, device=device)}
        return p

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              state: Optional[State] = None, chunk: Optional[KVChunk] = None,
              ) -> Tuple[torch.Tensor, Optional[State]]:
        ctx = ctx.scope(self.name)
        projs = self._projs()
        if chunk is not None:
            last = _row(state["shift"], chunk.slot).to(x.dtype)
        else:
            last = state["shift"] if state is not None else x.new_zeros(x.shape[0], 1,
                                                                         x.shape[-1])
        prev = torch.cat([last, x[:, :-1]], dim=1)
        mix = params["mix"]["x"]
        xk = x + mix[0] * (prev - x)
        xr = x + mix[1] * (prev - x)
        k = torch.square(F.relu(projs["wk"].apply(params["wk"], xk, ctx)))
        kv = projs["wv"].apply(params["wv"], k, ctx)
        y = torch.sigmoid(projs["wr"].apply(params["wr"], xr, ctx)) * kv
        if chunk is not None:
            tail = x[:, chunk.length - 1:chunk.length]
            new_state = {"shift": _put_row(state["shift"], chunk.slot, tail)}
        elif state is not None:
            new_state = {"shift": x[:, -1:]}
        else:
            new_state = None
        return y, new_state

    def init_state(self, batch: int, device, layers: Optional[int] = None) -> State:
        lead = (batch,) if layers is None else (layers, batch)
        return {"shift": torch.zeros(*lead, 1, self.d_model, dtype=torch.float32,
                                     device=device)}
