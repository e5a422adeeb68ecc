"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro.models.rglru``:

    a_t = exp(-c · softplus(Λ) · sigmoid(W_a x_t))        (per channel)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

with a short causal conv1d in front and a gated output, per the paper.
State is O(width).  The scan is a loop over the tokens of each chunk of at
most 256 (the JAX package's chunks, where it bounds the backward pass's
memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, einsum, gelu

C_CONST = 8.0
CONV_WIDTH = 4
SCAN_CHUNK = 256


def make_rglru(d_model, width=None) -> Params:
    w = width or d_model
    s = d_model ** -0.5
    p = Params()
    p.add("w_x", (d_model, w), s, axes=("embed", "ff"))     # input branch
    p.add("w_gate", (d_model, w), s, axes=("embed", "ff"))  # output gate
    p.add("conv", (CONV_WIDTH, w), 0.3, axes=(None, "ff"))
    p.add("w_a", (w, w), w ** -0.5, axes=("ff", "ff"))
    p.add("lam", (w,), 0.5, torch.float32, ("ff",))
    p.add("w_i", (w, w), w ** -0.5, axes=("ff", "ff"))
    p.add("w_out", (w, d_model), w ** -0.5, axes=("ff", "embed"))
    return p


def _conv1d(x, kernel, hist=None):
    """Causal depthwise conv, width CONV_WIDTH.  ``x``: (B,T,W).
    ``hist``: (B, CONV_WIDTH-1, W) carried for decode."""
    if hist is None:
        hist = torch.zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([hist, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * kernel[i].to(x.dtype)
              for i in range(CONV_WIDTH))
    return out, xp[:, -(CONV_WIDTH - 1):]


def _gates(p, u):
    log_a = (-C_CONST * F.softplus(p["lam"])
             * torch.sigmoid(einsum(
                 "btw,wv->btv", u, p["w_a"]).float()))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    i_gate = torch.sigmoid(einsum(
        "btw,wv->btv", u, p["w_i"]).float())
    return a, beta, i_gate


def _scan_chunk(h, a, drive):
    """h_t = a_t h_{t-1} + drive_t over one chunk's tokens: the last h and
    every (B,t,W) h."""
    hs = []
    for i in range(a.shape[1]):
        h = a[:, i] * h + drive[:, i]
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def rglru_forward(p, x, *, state=None, make_cache=False):
    b, t, d = x.shape
    u0 = einsum("btd,dw->btw", x, p["w_x"])
    gate = einsum("btd,dw->btw", x, p["w_gate"])
    h = state[0] if state is not None else \
        torch.zeros((b, u0.shape[2]), dtype=torch.float32, device=x.device)
    hist = state[1] if state is not None else None
    u, hist_new = _conv1d(u0, p["conv"], hist)
    a, beta, i_gate = _gates(p, u)
    drive = beta * i_gate * u.float()
    chunk = min(SCAN_CHUNK, t)
    while t % chunk:
        chunk -= 1
    hs = []
    for c in range(0, t, chunk):
        h, hc = _scan_chunk(h, a[:, c:c + chunk], drive[:, c:c + chunk])
        hs.append(hc)
    y = torch.cat(hs, dim=1).to(x.dtype)
    y = y * gelu(gate.float()).to(x.dtype)
    out = einsum("btw,wd->btd", y, p["w_out"])
    return out, ((h, hist_new) if make_cache else None)


def rglru_decode(p, x, state, *, position=None):
    out, new_state = rglru_forward(p, x, state=state, make_cache=True)
    return out, new_state
