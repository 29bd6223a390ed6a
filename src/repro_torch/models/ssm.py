"""Mamba2 / SSD (state-space duality) blocks — for the `ssm` and `hybrid`
families (mamba2-780m, jamba-1.5-large).

Prefill uses the chunked SSD algorithm: an intra-chunk quadratic term and an
inter-chunk state recurrence (a Python loop over chunks), so the heavy
compute is batched einsums over (chunk x chunk) tiles and the sequential
dependency is only O(S / chunk). Decode keeps an O(1) recurrent state per
layer: a (B, H, P, N) SSM state plus a (B, conv-1, channels) convolution
tail.

The input projection is split into w_z / w_x / w_BC / w_dt, with the
reference's keys and shapes. Numerics follow the reference: ``softplus`` is
``logaddexp(x, 0)`` (torch's own has a threshold at 20), the causal mask is
applied in log space before the ``exp``, and the mixed-dtype einsums run in
fp32 as jax promotes them.

Under a ``model`` axis the block is head-parallel, as the rules place it:
``w_z``/``w_x``/``w_dt``, the x convolution, ``A_log``/``D``/``dt_bias``,
the gated norm's scale and the cache's state and x tail are the rank's
block of heads, ``w_BC`` is replicated, and ``w_out`` is row-parallel (one
all-reduce). The gated RMSNorm normalises over the whole d_inner: its sum
of squares is all-reduced over ``model``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import tp
from repro_torch.models.layers import model_group, normal, rms_norm

_G = 1  # B/C projection groups (Mamba2 default n_groups=1)


def ssm_dims(cfg) -> tuple[int, int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = inner // P
    N = cfg.ssm_state
    return inner, H, P, N


def init_ssm(key, cfg, layer_dtype) -> dict:
    D = cfg.d_model
    inner, H, P, N = ssm_dims(cfg)
    s = D ** -0.5
    return {
        "w_z": normal(key, (D, inner), layer_dtype, s),
        "w_x": normal(key, (D, inner), layer_dtype, s),
        "w_BC": normal(key, (D, 2 * _G * N), layer_dtype, s),
        "w_dt": normal(key, (D, H), layer_dtype, s),
        "conv_x": normal(key, (cfg.ssm_conv, inner), layer_dtype, 0.1),
        "conv_bx": torch.zeros((inner,), dtype=layer_dtype),
        "conv_BC": normal(key, (cfg.ssm_conv, 2 * _G * N), layer_dtype, 0.1),
        "conv_bBC": torch.zeros((2 * _G * N,), dtype=layer_dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)),
        "D": torch.ones((H,), dtype=torch.float32),
        "dt_bias": torch.zeros((H,), dtype=torch.float32),
        "norm": torch.zeros((inner,), dtype=layer_dtype),
        "w_out": normal(key, (inner, D), layer_dtype, inner ** -0.5),
    }


def _heads(params, cfg):
    """The model group and the rank's SSM heads: every head with no
    ``model`` axis, else the rank's block (the rules split the head-wise
    leaves only when the heads divide)."""
    inner, H, P, _ = ssm_dims(cfg)
    if params["w_x"].shape[1] == inner:
        return None, H
    Hl = params["A_log"].shape[0]
    if Hl * P != params["w_x"].shape[1]:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not divide over the "
                         f"model axis that splits d_inner {inner}")
    return model_group(), Hl


def _gated_norm(y, z, scale, cfg, g):
    """``rms_norm(y * silu(z), scale)`` over the whole d_inner: with a
    ``model`` axis ``y`` and ``z`` are the rank's columns, and their sum of
    squares is all-reduced (its gradient too: every rank's columns read
    it)."""
    if g is None:
        return rms_norm(y * F.silu(z), scale, cfg.norm_eps)
    x = (y * F.silu(z)).float()
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    var = tp.copy(tp.reduce(sq, g), g) / (cfg.ssm_expand * cfg.d_model)
    return ((x * torch.rsqrt(var + cfg.norm_eps)) * (1.0 + scale.float())).to(y.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u, conv_w, conv_b):
    """Depthwise causal conv1d over (B, S, C) with kernel (W, C)."""
    W = conv_w.shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * conv_w[0]
    for i in range(1, W):
        out = out + pad[:, i : i + S, :] * conv_w[i]
    return F.silu(out + conv_b)


def ssd_apply(params, x_in, cfg, chunk: int = 128, return_state: bool = False):
    """Full-sequence SSD. x_in: (B, S, D) -> (B, S, D) [, decode cache]."""
    Bsz, S, Dm = x_in.shape
    _, _, P, N = ssm_dims(cfg)
    g, H = _heads(params, cfg)
    inner = H * P
    f32 = torch.float32
    xf = tp.copy(x_in, g)
    z = xf @ params["w_z"]
    x_raw = xf @ params["w_x"]
    BC_raw = x_in @ params["w_BC"]
    dt_raw = xf @ params["w_dt"]

    xc = _causal_conv(x_raw, params["conv_x"], params["conv_bx"])
    # B and C are every head's: their gradient from the rank's heads is a share
    BCc = tp.copy(_causal_conv(BC_raw, params["conv_BC"], params["conv_bBC"]), g)
    x = xc.reshape(Bsz, S, H, P)
    Bm = BCc[..., : _G * N].reshape(Bsz, S, _G, N)
    Cm = BCc[..., _G * N :].reshape(Bsz, S, _G, N)

    dt = softplus(dt_raw.float() + params["dt_bias"])   # (B,S,H)
    A = -torch.exp(params["A_log"])                      # (H,)
    a = dt * A[None, None, :]                            # log-decay

    if S % chunk != 0:
        chunk = S  # smoke-test sizes
    nc = S // chunk
    ar = a.reshape(Bsz, nc, chunk, H)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    xr = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    Br = Bm.reshape(Bsz, nc, chunk, _G, N)
    Cr = Cm.reshape(Bsz, nc, chunk, _G, N)

    cum = torch.cumsum(ar, dim=2)                        # (B,nc,Q,H)
    total = cum[:, :, -1, :]                             # (B,nc,H)

    # ---- intra-chunk (quadratic within chunk) ----
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    iq = np.arange(chunk)
    causal = torch.from_numpy(iq[:, None] >= iq[None, :]).to(x_in.device)
    # mask in log space BEFORE exp: the masked (positive) entries would
    # overflow to inf
    li = li.masked_fill(~causal[None, None, :, :, None], -1e30)
    L = torch.exp(li)
    cb = torch.einsum("bcqgn,bckgn->bcqkg", Cr, Br)      # (B,nc,Q,Q,G)
    att = cb[..., 0].to(f32)                             # G == 1: (B,nc,Q,Q)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp",
                           att[..., None] * L * dtr[:, :, None, :, :], xr)

    # ---- chunk states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum("bckh,bckn,bckhp->bchpn", decay_to_end * dtr,
                          Br[:, :, :, 0, :].to(f32), xr)

    # ---- inter-chunk recurrence ----
    carry = torch.zeros((Bsz, H, P, N), dtype=f32, device=x_in.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    final_state = carry
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp",
                           Cr[:, :, :, 0, :].to(f32), prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + params["D"][None, None, :, None] * x.to(f32)
    y = y.reshape(Bsz, S, inner).to(x_in.dtype)
    y = _gated_norm(y, z, params["norm"], cfg, g)
    out = tp.reduce(y @ params["w_out"], g)
    if return_state:
        W = params["conv_x"].shape[0]
        if S >= W - 1:
            tail_x = x_raw[:, S - (W - 1):, :]
            tail_BC = BC_raw[:, S - (W - 1):, :]
        else:
            tail_x = F.pad(x_raw, (0, 0, W - 1 - S, 0))
            tail_BC = F.pad(BC_raw, (0, 0, W - 1 - S, 0))
        # the B/C tail as the cache holds it: the rank's channels where
        # they divide over model
        m = tp.size(model_group())
        if m > 1 and tail_BC.shape[-1] % m == 0:
            tail_BC = tp.part(tail_BC, tail_BC.shape[-1] // m, model_group())
        return out, {"state": final_state,
                     "conv_x": tail_x.to(x_in.dtype),
                     "conv_BC": tail_BC.to(x_in.dtype)}
    return out


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> dict:
    inner, H, P, N = ssm_dims(cfg)
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, inner), dtype=dtype,
                              device=device),
        "conv_BC": torch.zeros((batch, cfg.ssm_conv - 1, 2 * _G * N), dtype=dtype,
                               device=device),
    }


def ssd_decode(params, x_in, cache, cfg):
    """One-token recurrent step. x_in: (B, 1, D) -> (B, 1, D), cache.

    The cache is updated in place and returned: its state and conv tails
    are the tensors passed in, advanced by one token. Under a ``model``
    axis they are the rank's heads and channels: its B/C tail runs the
    depthwise convolution on its channels, whose outputs are gathered."""
    Bsz = x_in.shape[0]
    _, _, P, N = ssm_dims(cfg)
    g, H = _heads(params, cfg)
    inner = H * P
    f32 = torch.float32
    xf = tp.copy(x_in, g)
    z = (xf @ params["w_z"])[:, 0]
    x_raw = (xf @ params["w_x"])[:, 0]
    BC_raw = (x_in @ params["w_BC"])[:, 0]
    dt_raw = (xf @ params["w_dt"])[:, 0]

    win_x = torch.cat([cache["conv_x"], x_raw[:, None, :]], dim=1)
    xc = F.silu(torch.einsum("bwc,wc->bc", win_x, params["conv_x"])
                + params["conv_bx"])
    nbc = cache["conv_BC"].shape[-1]
    gbc = model_group() if nbc < 2 * _G * N else None
    win_BC = torch.cat([cache["conv_BC"], tp.part(BC_raw, nbc, gbc)[:, None, :]],
                       dim=1)
    BCc = F.silu(torch.einsum("bwc,wc->bc", win_BC, tp.part(params["conv_BC"], nbc, gbc))
                 + tp.part(params["conv_bBC"], nbc, gbc))
    BCc = tp.gather(BCc, -1, gbc)
    x = xc.reshape(Bsz, H, P)
    Bm = BCc[..., : _G * N].reshape(Bsz, N)
    Cm = BCc[..., _G * N :].reshape(Bsz, N)
    dt = softplus(dt_raw.float() + params["dt_bias"])   # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])                   # (B,H)
    state = cache["state"]
    state.mul_(decay[:, :, None, None]).add_(torch.einsum(
        "bh,bhp,bn->bhpn", dt, x.to(f32), Bm.to(f32)))
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), state)
    y = y + params["D"][None, :, None] * x.to(f32)
    y = y.reshape(Bsz, inner).to(x_in.dtype)
    y = _gated_norm(y, z, params["norm"], cfg, g)
    out = tp.reduce(y @ params["w_out"], g)[:, None, :]
    cache["conv_x"].copy_(win_x[:, 1:, :])
    cache["conv_BC"].copy_(win_BC[:, 1:, :])
    return out, cache
