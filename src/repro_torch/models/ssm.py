"""State-space token mixing: the RWKV-6 (Finch) and Mamba-2 (SSD) blocks.

Port of ``src/repro/models/ssm.py`` (``RWKVState``, ``RWKV6Block``,
``MambaState``, ``Mamba2Block``).  RWKV-6's time mix reduces to the
chunked linear recurrence

    S_t = diag(d_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + u k_t^T v_t)

with a per-channel data-dependent decay ``d_t = exp(-exp(w0 + tanh(x A)
B))`` and the bonus ``u`` on the current token.  The full-sequence path
(:meth:`RWKV6Block.time_mix`, training and prefill) runs it through
:func:`repro_torch.kernels.ops.linear_scan` in ``rwkv6`` mode (kernel B8
on a CUDA tensor, its plain twin on the CPU); the decode path
(:meth:`RWKV6Block.time_mix_step`) is the single-step recurrence on a
carried state, plain torch ops, as in the reference.  As in the
reference, token-shift mixing uses static per-channel coefficients for
r/k/v/g and the decay keeps its data-dependent low-rank path.

Parameter names are the reference's (``mix.*``, ``r``, ``k``, ``v``,
``g``, ``o``, ``w0``, ``wA``, ``wB``, ``u``, ``ln_x``, ``cm_mix.*``,
``cm_k``, ``cm_v``, ``cm_r``), so
:func:`repro_torch.convert.params_from_numpy` loads reference weights.
Every projection consults the TNN config by target (``mix`` for r/k/v/g
and ``cm_r``, ``out`` for o, ``mlp`` for ``cm_k``/``cm_v``).

Mamba-2 (:class:`Mamba2Block`) is SSD with one decay ``exp(a dt)`` per
head and token, B/C shared across heads, a depthwise causal conv (f32)
on x/B/C and a gated output; its projections are ``in`` (target ``mix``)
and ``out`` (target ``out``).  The full-sequence path runs the scan in
``ssd`` mode with the log-decay broadcast over ``dk`` as an expanded
view, so B8 (and its twin on the CPU) takes the overflow-free form
(:func:`repro_torch.kernels.ref.scalar_decay`) at Mamba-2's init decay
of about -0.69 a token, where the reference's factored form overflows
f32 at chunk 128; the decode path is the reference's single-step
recurrence on a :class:`MambaState`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.tensorized import TNNConfig
from repro_torch.kernels import ops
from repro_torch.models.blocks import groupnorm_heads, make_dense


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # [B, H, dk, dv] f32 recurrence state
    shift_tm: torch.Tensor   # [B, D] previous token (time mix)
    shift_cm: torch.Tensor   # [B, D] previous token (channel mix)


def token_shift(z: torch.Tensor) -> torch.Tensor:
    """``z [B, T, D]`` moved one token later, zeros in front."""
    return torch.nn.functional.pad(z, (0, 0, 1, 0))[:, :-1]


def scan_chunk(T: int, chunk: int = 128) -> int:
    """The scan chunk the full-sequence time mix uses for ``T`` tokens:
    ``chunk`` where it divides ``T``, else ``gcd(T, chunk)``, and never
    more than ``T`` (the reference's rule)."""
    if T % chunk != 0:
        chunk = math.gcd(T, chunk) or 1
    return min(chunk, T)


class RWKV6Block(nn.Module):
    def __init__(self, d_model: int, head_dim: int = 64,
                 d_ff: int | None = None, decay_lora: int = 64,
                 tnn: TNNConfig | None = None, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        D = self.d_model = d_model
        hd = self.head_dim = head_dim
        H = self.num_heads = d_model // head_dim
        self.ff = d_ff or int(3.5 * d_model)
        self.compute_dtype = compute_dtype
        f32 = torch.float32

        def full(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=f32,
                                           device=device))

        def randn(shape, std, dtype=f32):
            return nn.Parameter((torch.randn(shape, generator=generator)
                                 * std).to(device=device, dtype=dtype))

        def proj(d_in, d_out, target="mix"):
            t = tnn if (tnn and target in tnn.targets) else None
            return make_dense(d_in, d_out, tnn=t, param_dtype=param_dtype,
                              compute_dtype=compute_dtype, device=device,
                              generator=generator)

        self.mix = nn.ParameterDict({n: full((D,), 0.5) for n in "rkvgw"})
        self.r, self.k, self.v, self.g = (proj(D, D) for _ in range(4))
        self.o = proj(D, D, target="out")
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        self.w0 = full((D,), -2.0)
        self.wA = randn((D, decay_lora), 0.01, param_dtype)
        self.wB = randn((decay_lora, D), 0.01, param_dtype)
        self.u = randn((H, hd), 0.1)
        self.ln_x = full((H, hd), 1.0)
        # channel mix
        self.cm_mix = nn.ParameterDict({n: full((D,), 0.5) for n in "rk"})
        self.cm_k = proj(D, self.ff, target="mlp")
        self.cm_v = proj(self.ff, D, target="mlp")
        self.cm_r = proj(D, D)

    # -- helpers -------------------------------------------------------------

    def _log_decay(self, xw: torch.Tensor) -> torch.Tensor:
        """Data-dependent per-channel log-decay (< 0), f32."""
        lo = torch.tanh(xw.float() @ self.wA.float())
        lo = lo @ self.wB.float()
        return -torch.exp(self.w0 + lo)

    def _time_mix(self, x: torch.Tensor, x_prev: torch.Tensor):
        """x, x_prev: ``[B, T, D]`` (x_prev the token-shifted input)."""
        def mx(name):
            return x + (x_prev - x) * self.mix[name].to(x.dtype)
        return (self.r(mx("r")), self.k(mx("k")), self.v(mx("v")),
                self.g(mx("g")), self._log_decay(mx("w")))

    def _wkv_out(self, wkv: torch.Tensor, g: torch.Tensor, B: int, T: int
                 ) -> torch.Tensor:
        out = groupnorm_heads(wkv, self.ln_x)                 # [B,T,H,hd]
        out = out.reshape(B, T, self.d_model) * torch.nn.functional.silu(
            g.float()).to(out.dtype)
        return self.o(out)

    def channel_mix(self, x: torch.Tensor, x_prev: torch.Tensor
                    ) -> torch.Tensor:
        xk = x + (x_prev - x) * self.cm_mix["k"].to(x.dtype)
        xr = x + (x_prev - x) * self.cm_mix["r"].to(x.dtype)
        k = (torch.relu(self.cm_k(xk).float()) ** 2).to(x.dtype)
        v = self.cm_v(k)
        r = torch.sigmoid(self.cm_r(xr).float()).to(x.dtype)
        return r * v

    # -- full-sequence (training / prefill) ----------------------------------

    def time_mix(self, x: torch.Tensor, chunk: int = 128
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """x: ``[B, T, D]`` (pre-normed).  Returns ``(out, final wkv state
        [B, H, hd, hd] f32)``; the state feeds decode after prefill.  The
        scan runs in chunks of :func:`scan_chunk` ``(T, chunk)``."""
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim
        r, k, v, g, ld = self._time_mix(x, token_shift(x))

        def heads(z):
            return z.reshape(B, T, H, hd).transpose(1, 2).reshape(
                B * H, T, hd)

        u = self.u.expand(B, H, hd).reshape(B * H, hd)
        wkv, state = ops.linear_scan(heads(r), heads(k), heads(v), heads(ld),
                                     u, mode="rwkv6",
                                     chunk=scan_chunk(T, chunk))
        wkv = wkv.reshape(B, H, T, hd).transpose(1, 2)         # [B,T,H,hd]
        return self._wkv_out(wkv, g, B, T), state.reshape(B, H, hd, hd)

    # -- decode ---------------------------------------------------------------

    def init_state(self, batch: int) -> RWKVState:
        H, hd, D = self.num_heads, self.head_dim, self.d_model
        dev = self.w0.device
        return RWKVState(
            wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                            device=dev),
            shift_tm=torch.zeros((batch, D), dtype=self.compute_dtype,
                                 device=dev),
            shift_cm=torch.zeros((batch, D), dtype=self.compute_dtype,
                                 device=dev))

    def time_mix_step(self, x: torch.Tensor, wkv_state: torch.Tensor,
                      shift: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Single-token time mix.  x: ``[B, 1, D]`` (pre-normed);
        wkv_state ``[B, H, hd, hd]`` f32; shift ``[B, D]`` the previous
        token.  Returns ``(out [B, 1, D], new wkv state, new shift)``."""
        B, _, D = x.shape
        H, hd = self.num_heads, self.head_dim
        prev = shift[:, None, :].to(x.dtype)
        r, k, v, g, ld = self._time_mix(x, prev)
        rh, kh, vh = (z.reshape(B, H, hd).float() for z in (r, k, v))
        dh = torch.exp(ld.reshape(B, H, hd).float())
        kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
        seen = wkv_state + self.u[None, ..., None] * kv
        wkv = torch.einsum("bhk,bhkv->bhv", rh, seen)           # [B, H, hd]
        new_wkv = wkv_state * dh[..., None] + kv
        out = self._wkv_out(wkv.reshape(B, 1, H, hd).to(x.dtype), g, B, 1)
        return out, new_wkv, x[:, -1].to(shift.dtype)

    def channel_mix_step(self, x: torch.Tensor, shift: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Single-token channel mix.  x: ``[B, 1, D]`` (pre-normed)."""
        out = self.channel_mix(x, shift[:, None, :].to(x.dtype))
        return out, x[:, -1].to(shift.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    ssm: torch.Tensor    # [B, H, dk, hd] f32 recurrence state
    conv: torch.Tensor   # [B, conv_width - 1, conv_dim] f32 conv window


class Mamba2Block(nn.Module):
    """Parameters (the reference's names): ``in`` (``[z, x, B, C, dt]``
    projection), ``conv_w`` ``[W, conv_dim]``, ``conv_b``, ``A_log``
    (``a = -exp(A_log)``), ``D_skip``, ``dt_bias``, ``norm``, ``out``."""

    def __init__(self, d_model: int, d_state: int = 64, head_dim: int = 64,
                 expand: int = 2, conv_width: int = 4,
                 tnn: TNNConfig | None = None, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_model, self.d_state, self.head_dim = d_model, d_state, head_dim
        self.conv_width = conv_width
        self.compute_dtype = compute_dtype
        DI = self.d_inner = expand * d_model
        H = self.num_heads = DI // head_dim
        self.conv_dim = DI + 2 * d_state
        f32 = torch.float32

        def proj(d_in, d_out, target):
            t = tnn if (tnn and target in tnn.targets) else None
            return make_dense(d_in, d_out, tnn=t, param_dtype=param_dtype,
                              compute_dtype=compute_dtype, device=device,
                              generator=generator)

        # "in" is a Python keyword: registered by name, read by getattr.
        self.add_module("in", proj(d_model, 2 * DI + 2 * d_state + H, "mix"))
        self.conv_w = nn.Parameter(
            (torch.randn((conv_width, self.conv_dim), generator=generator)
             * 0.1).to(device=device, dtype=f32))
        self.conv_b = nn.Parameter(torch.zeros(self.conv_dim, device=device))
        self.A_log = nn.Parameter(torch.zeros(H, device=device))
        self.D_skip = nn.Parameter(torch.ones(H, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, device=device))
        self.norm = nn.Parameter(torch.ones(DI, device=device))
        self.out = proj(DI, d_model, "out")

    def _split(self, x: torch.Tensor):
        """in_proj + split.  x: ``[B, T, D]``."""
        DI, S = self.d_inner, self.d_state
        zxbcdt = getattr(self, "in")(x)
        return torch.split(zxbcdt, [DI, DI, S, S, self.num_heads], dim=-1)

    def _conv_train(self, u: torch.Tensor) -> torch.Tensor:
        """Depthwise causal conv over ``u [B, T, conv_dim]``, in f32."""
        w = self.conv_w.float()
        T = u.shape[1]
        up = torch.nn.functional.pad(u.float(), (0, 0, self.conv_width - 1, 0))
        out = up[:, 0:T] * w[0]
        for i in range(1, self.conv_width):
            out = out + up[:, i:i + T] * w[i]
        return torch.nn.functional.silu(out + self.conv_b).to(u.dtype)

    def _gate_out(self, y: torch.Tensor, z: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """Gate by ``silu(z)``, scale by ``norm``, project out."""
        y = y * torch.nn.functional.silu(z.float()).to(y.dtype)
        y = (y.float() * self.norm).to(dtype)
        return self.out(y)

    def _ssd(self, xs, Bm, Cm, dt, chunk: int):
        """The scan over ``[B*H, T, .]`` streams: ``q = C``, ``k = B dt``,
        ``v`` = the head's x, log-decay ``dt a`` per (stream, token)
        broadcast over ``dk``.  Returns ``(y [B, T, d_inner] f32, final
        state [B, H, dk, hd] f32)``."""
        B_, T = xs.shape[:2]
        H, hd, S = self.num_heads, self.head_dim, self.d_state
        dt = torch.nn.functional.softplus(dt.float() + self.dt_bias)
        ld = dt * -torch.exp(self.A_log)                       # [B, T, H]
        xh = xs.reshape(B_, T, H, hd)

        def stream(z, d):                                      # shared B / C
            return z[:, None].expand(B_, H, T, d).reshape(B_ * H, T, d)

        dth = dt.transpose(1, 2).reshape(B_ * H, T, 1)
        k = stream(Bm, S) * dth
        q = stream(Cm, S)
        v = xh.transpose(1, 2).reshape(B_ * H, T, hd)
        # One scalar per (stream, token), broadcast over dk as an expanded
        # view (stride 0): the form the scan takes without overflow.  The
        # [B*H, T] merge is made contiguous first, so the view survives.
        ldk = ld.transpose(1, 2).reshape(B_ * H, T)[..., None].expand(
            B_ * H, T, S)
        cd = self.compute_dtype
        y, state = ops.linear_scan(q.to(cd), k.to(cd), v.to(cd), ldk,
                                   mode="ssd", chunk=scan_chunk(T, chunk))
        y = y.reshape(B_, H, T, hd).transpose(1, 2)            # [B,T,H,hd]
        y = y + xh * self.D_skip[None, None, :, None]
        return y.reshape(B_, T, self.d_inner), state.reshape(B_, H, S, hd)

    def forward(self, x: torch.Tensor, chunk: int = 128,
                return_state: bool = False):
        """x: ``[B, T, D]`` (pre-normed).  With ``return_state`` also the
        decode state: the scan's final state and the conv window's last
        ``conv_width - 1`` inputs (zeros in front when ``T`` is
        shorter)."""
        B, T, _ = x.shape
        z, xs, Bm, Cm, dt = self._split(x)
        conv_in = torch.cat([xs, Bm, Cm], dim=-1)
        conv_out = self._conv_train(conv_in)
        xs, Bm, Cm = torch.split(
            conv_out, [self.d_inner, self.d_state, self.d_state], dim=-1)
        y, ssm_state = self._ssd(xs, Bm, Cm, dt, chunk)
        out = self._gate_out(y, z, x.dtype)
        if not return_state:
            return out
        w = self.conv_width - 1
        tail = conv_in[:, max(T - w, 0):].float()
        pad = torch.zeros((B, max(0, w - T), self.conv_dim),
                          dtype=torch.float32, device=x.device)
        return out, MambaState(ssm=ssm_state,
                               conv=torch.cat([pad, tail], dim=1))

    # -- decode ---------------------------------------------------------------

    def init_state(self, batch: int) -> MambaState:
        dev = self.norm.device
        return MambaState(
            ssm=torch.zeros((batch, self.num_heads, self.d_state,
                             self.head_dim), dtype=torch.float32, device=dev),
            conv=torch.zeros((batch, self.conv_width - 1, self.conv_dim),
                             dtype=torch.float32, device=dev))

    def decode_step(self, x: torch.Tensor, state: MambaState
                    ) -> tuple[torch.Tensor, MambaState]:
        """x: ``[B, 1, D]`` (pre-normed) -> ``(out [B, 1, D], new state)``:
        the conv over the carried window, then ``S = S exp(a dt) + dt
        B^T x``, ``y = C S + D x``, in f32."""
        B = x.shape[0]
        H, hd, S, DI = self.num_heads, self.head_dim, self.d_state, \
            self.d_inner
        z, xs, Bm, Cm, dt = self._split(x)
        u = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]             # [B, conv_dim]
        window = torch.cat([state.conv, u[:, None].float()], dim=1)
        conv = torch.nn.functional.silu(
            torch.sum(window * self.conv_w.float()[None], dim=1)
            + self.conv_b)                                     # [B, C]
        xs, Bm, Cm = conv[:, :DI], conv[:, DI:DI + S], conv[:, DI + S:]
        dtv = torch.nn.functional.softplus(dt[:, 0].float() + self.dt_bias)
        decay = torch.exp(dtv * -torch.exp(self.A_log))       # [B, H]
        xh = xs.reshape(B, H, hd).float()
        kv = torch.einsum("bs,bhp->bhsp", Bm.float(), xh)
        new_ssm = (state.ssm * decay[..., None, None]
                   + kv * dtv[..., None, None])
        y = torch.einsum("bs,bhsp->bhp", Cm.float(), new_ssm)
        y = y + xh * self.D_skip[None, :, None]
        y = y.reshape(B, 1, DI).to(x.dtype)
        out = self._gate_out(y, z, x.dtype)
        return out, MambaState(ssm=new_ssm, conv=window[:, 1:])
