"""Mamba2's mixer, state-space duality (SSD) chunked (arXiv 2405.21060 §6),
ported from the JAX package's ``repro/nn/ssm.py``.

SSD computes a selective-SSM scan as quadratic, attention-like products
within chunks of ``chunk`` steps and a low-rank state recurrence between
chunks.  The JAX package has no Pallas kernel here (its scan is einsums),
so the port is plain PyTorch: every product a batched matmul, f32 inside.
``torch.einsum`` contracts more than two operands left to right, so each of
JAX's 3- and 4-operand contractions is written as explicit pairwise
products whose intermediates stay at (B, C, H, L, L) or smaller.

Shapes: x (B,S,H,P) heads × head_dim, a (H,) decay rates, b/c (B,S,G,N)
state projections (G groups broadcast to H heads), dt (B,S,H) step sizes.
Decode keeps a recurrent state (B,H,P,N) and a depthwise-conv ring of the
last ``d_conv − 1`` inputs; ``ssm_decode_step`` updates both in place (JAX
returns new ones; its serve step donates the old).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.nn.common import _device, dense_init, norm_apply


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_dim(self) -> int:
        # [z (gate), x, B, C, dt]
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state \
            + self.n_heads


def _uniform(gen, shape, lo: float, hi: float):
    """U[lo, hi) in f32 on the generator's device (meta for ``gen=None``)."""
    t = torch.empty(shape, dtype=torch.float32, device=_device(gen))
    if gen is not None:
        t.uniform_(lo, hi, generator=gen)
    return t


def ssm_init(gen, cfg: SSMConfig, dtype) -> dict:
    """JAX's distributions, drawn from ``gen``: in_proj and out_proj
    truncated normal, conv_w normal · d_conv^−½, dt_bias the inverse
    softplus of a log-uniform step in [dt_min, dt_max], A_log the log of
    U[1, 16), D ones (the last three in f32)."""
    dev = _device(gen)
    params = {"in_proj": dense_init(gen, cfg.d_model, cfg.proj_dim, dtype)}
    w = torch.empty((cfg.d_conv, cfg.conv_dim), dtype=torch.float32,
                    device=dev)
    if gen is not None:
        w.normal_(generator=gen)
    params["conv_w"] = w.to(dtype) * cfg.d_conv ** -0.5
    params["conv_b"] = torch.zeros(cfg.conv_dim, dtype=dtype, device=dev)
    u = _uniform(gen, (cfg.n_heads,), 0.0, 1.0)
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt0 = torch.exp(u * (hi - lo) + lo)
    params["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))
    params["A_log"] = torch.log(_uniform(gen, (cfg.n_heads,), 1.0, 16.0))
    params["D"] = torch.ones(cfg.n_heads, dtype=torch.float32, device=dev)
    params["norm_scale"] = torch.ones(cfg.d_inner, dtype=dtype, device=dev)
    params["out_proj"] = dense_init(gen, cfg.d_inner, cfg.d_model, dtype,
                                    stddev=cfg.d_inner ** -0.5)
    return params


def _segsum(x):
    """x (..., L) → (..., L, L) with out[i, j] = Σ_{j<k≤i} x[k], −inf above
    the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, -math.inf)


def ssd_scan(x, dt, a, b, c, chunk: int, initial_state=None):
    """Chunked SSD.  x (B,S,H,P), dt (B,S,H) (post-softplus), a (H,)
    negative, b/c (B,S,G,N), S a multiple of ``chunk``.  Returns (y
    (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    bs, s, h, p_ = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_scan: S {s} is not a multiple of the chunk "
                         f"{chunk}")
    nc = s // chunk
    rep = h // g

    xf = (x * dt[..., None]).float()                       # dt-weighted input
    adt = (a[None, None, :] * dt).float()                  # (B,S,H)
    xc = xf.reshape(bs, nc, chunk, h, p_)                  # (B,C,L,H,P)
    ac = adt.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)  # (B,H,C,L)
    bch = b.float().reshape(bs, nc, chunk, g, n) \
        .repeat_interleave(rep, dim=3)                     # (B,C,L,H,N)
    cch = c.float().reshape(bs, nc, chunk, g, n) \
        .repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(ac, dim=-1)                        # (B,H,C,L)

    # 1. intra-chunk (quadratic, attention-like): (C·Bᵀ ∘ L) · x
    ldecay = torch.exp(_segsum(ac))                        # (B,H,C,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", cch, bch)
    scores = scores * ldecay.permute(0, 2, 1, 3, 4)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    del scores, ldecay

    # 2. chunk states: Σ_l b ⊗ (x · decay to the chunk's end)
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)        # (B,H,C,L)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", bch, xd)

    # 3. inter-chunk recurrence over chunk states
    if initial_state is None:
        initial_state = torch.zeros((bs, h, p_, n), dtype=torch.float32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None].float(), states], dim=1)
    chunk_sum = a_cs[..., -1]                              # (B,H,C)
    decay_chunk = torch.exp(_segsum(F.pad(chunk_sum, (1, 0))))
    decay_chunk = torch.where(torch.isfinite(decay_chunk), decay_chunk, 0.0)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_in, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state → output within the chunk
    state_decay_out = torch.exp(a_cs)                      # (B,H,C,L)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cch, states_in)
    y_off = y_off * state_decay_out.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(bs, s, h, p_).to(x.dtype)
    return y, final_state


def _split_proj(cfg: SSMConfig, zxbcdt):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _split_xbc(cfg: SSMConfig, xbc, batch_shape):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    x = xbc[..., :di].reshape(*batch_shape, cfg.n_heads, cfg.head_dim)
    b = xbc[..., di: di + gn].reshape(*batch_shape, cfg.n_groups,
                                      cfg.d_state)
    c = xbc[..., di + gn:].reshape(*batch_shape, cfg.n_groups, cfg.d_state)
    return x, b, c


def _gated_out(p, cfg: SSMConfig, y, x, z):
    """y + D·x, the gated RMSNorm (mamba2: norm(y · silu(z))) and out_proj;
    y and x (..., H, P)."""
    y = y + x * p["D"][:, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    y = norm_apply({"scale": p["norm_scale"]}, y * F.silu(z))
    return y @ p["out_proj"]["w"]


def ssm_apply(p, cfg: SSMConfig, u, *, return_cache: bool = False):
    """Full-sequence Mamba2 mixer.  u (B,S,D) → (B,S,D).

    ``return_cache=True`` also returns the decode cache after the last
    position (prefill: the final SSM state and the conv ring's tail)."""
    bs, s, _ = u.shape
    z, xbc_raw, dt = _split_proj(cfg, u @ p["in_proj"]["w"])
    # causal depthwise conv over the sequence, tap by tap in JAX's order
    k = cfg.d_conv
    xbc_pad = F.pad(xbc_raw, (0, 0, k - 1, 0))
    conv = xbc_pad[:, 0:s] * p["conv_w"][0]
    for i in range(1, k):
        conv = conv + xbc_pad[:, i: i + s] * p["conv_w"][i]
    xbc = F.silu(conv + p["conv_b"])
    x, b, c = _split_xbc(cfg, xbc, (bs, s))
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    pad = (-s) % cfg.chunk
    if pad:
        # dt = 0 on the padding: exp(a·0) = 1 and x·dt = 0, so the padded
        # steps leave the state as it was (prefill stays exact)
        y, final_state = ssd_scan(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(b, (0, 0, 0, 0, 0, pad)), F.pad(c, (0, 0, 0, 0, 0, pad)),
            cfg.chunk)
        y = y[:, :s]
    else:
        y, final_state = ssd_scan(x, dt, a, b, c, cfg.chunk)
    out = _gated_out(p, cfg, y, x, z)
    if return_cache:
        return out, {"conv": xbc_pad[:, -(k - 1):].contiguous(),
                     "state": final_state}
    return out


# --------------------------------------------------------------------- #
# decode                                                                #
# --------------------------------------------------------------------- #

def init_ssm_cache(cfg: SSMConfig, batch: int, dtype, device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                                  cfg.d_state), dtype=torch.float32,
                                 device=device)}


def ssm_decode_step(p, cfg: SSMConfig, u, cache):
    """One token.  u (B,1,D); O(1) state update, no KV growth.  Updates
    ``cache`` in place and returns (y (B,1,D), cache)."""
    bs = u.shape[0]
    z, xbc_new, dt = _split_proj(cfg, u[:, 0] @ p["in_proj"]["w"])
    window = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)  # (B,K,C)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    x, b, c = _split_xbc(cfg, F.silu(conv), (bs,))
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    a = -torch.exp(p["A_log"])                                    # (H,)
    rep = cfg.n_heads // cfg.n_groups
    bh = b.repeat_interleave(rep, dim=1).float()                  # (B,H,N)
    ch = c.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(a[None] * dt)                               # (B,H)
    xdt = x.float() * dt[..., None]                               # (B,H,P)
    state = cache["state"] * decay[..., None, None] \
        + xdt[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch).to(u.dtype)
    out = _gated_out(p, cfg, y, x, z)[:, None]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache
