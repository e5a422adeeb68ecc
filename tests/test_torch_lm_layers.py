"""The port's LM layers (``repro_torch.models.{layers, attention, moe,
rglru, rwkv6}``) against the JAX package's functions, one by one on the
CPU: the JAX ``make_*`` parameters carried across, the same numpy-seeded
inputs, the JAX functions compiled with XLA's excess precision off
(``torch_lm.strict_jit``) so that both round every bf16 result as their
code says.

``TOL`` is the rel-L2 a layer's output and cache may differ by: a
different summation order in a bf16 product flips an occasional rounding
by one ulp (bf16 keeps 8 bits, 3.9e-3 of a value), and one layer does not
compound it.  Where both take the same steps, as the cache writes, the
test asks for equality.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch_lm import as_numpy, rel_l2, strict_jit  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402

#: rel-L2 of one layer's output (see the module's docstring)
TOL = 4e-3
D, H, HKV, DH = 64, 4, 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores.  The layers run
    without autograd, as serving runs them."""
    n, grad = torch.get_num_threads(), torch.is_grad_enabled()
    torch.set_num_threads(1)
    torch.set_grad_enabled(False)
    yield
    torch.set_num_threads(n)
    torch.set_grad_enabled(grad)


def _load(node, tree):
    """A port :class:`Params` node holding the JAX parameter dict ``tree``
    (on the CPU)."""
    node.to_empty(device="cpu")
    node.load_state_dict({k: torch.from_numpy(v) for k, v in
                          as_numpy(tree).items()})
    return node


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(a: np.ndarray, dtype=torch.bfloat16):
    """The same values for both packages: a torch tensor of ``dtype`` and
    the JAX array of the same dtype."""
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16
                    else jnp.float32)
    return t, j


def _close(got, want, tol=TOL):
    got = got.float() if torch.is_tensor(got) else got
    assert got.shape == np.shape(want)
    assert rel_l2(got, as_numpy(want)) <= tol


# --------------------------------------------------------------------- #
# norms, RoPE, MLPs, embeddings
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_matches(dtype):
    t, j = _pair(_x((2, 5, D)), dtype)
    w = _x((D,), 1)
    got = tlayers.rms_norm(t, torch.from_numpy(w), 1e-6)
    assert got.dtype == dtype
    _close(got, strict_jit(jlayers.rms_norm)(j, jnp.asarray(w)), 1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_the_half_split(theta, per_slot):
    """Halves rotate as pairs (concatenated, not interleaved), at shared
    positions (1, T) or per-slot ones (B, 1)."""
    t, j = _pair(_x((3, 6, H, DH)))
    pos = np.arange(6)[None] if not per_slot else \
        np.asarray([[5], [17], [4000]])
    got = tlayers.apply_rope(t, torch.from_numpy(pos), theta)
    want = strict_jit(lambda x, p: jlayers.apply_rope(x, p, theta))(
        j, jnp.asarray(pos))
    assert got.dtype == torch.bfloat16
    _close(got, want)
    # position 0 rotates nothing
    zero = tlayers.apply_rope(t, torch.zeros((1, 6), dtype=torch.int64),
                              theta)
    assert torch.equal(zero, t)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2"])
def test_mlp_matches(kind):
    params, _ = jlayers.make_mlp(jax.random.key(1), D, 4 * D, kind)
    p = _load(tlayers.make_mlp(D, 4 * D, kind), params)
    t, j = _pair(_x((2, 7, D)))
    _close(tlayers.mlp(p, t, kind),
           strict_jit(lambda pp, x: jlayers.mlp(pp, x, kind))(params, j))


def test_embedding_and_unembedding_match():
    table, _ = jlayers.make_embedding(jax.random.key(2), 50, D)
    node = tlayers.Params()
    tlayers.make_embedding(node, 50, D)
    _load(node, {"embedding": table})
    tokens = np.random.default_rng(3).integers(0, 50, (2, 9))
    x = tlayers.embed(node["embedding"], torch.from_numpy(tokens))
    assert np.array_equal(x.float().detach().numpy(),
                          as_numpy(jlayers.embed(table, tokens)))
    t, j = _pair(_x((2, 9, D)))
    got = tlayers.unembed(node["embedding"], t)
    assert got.dtype == torch.float32
    _close(got, strict_jit(jlayers.unembed)(table, j), 1e-6)


# --------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------- #
GQA_CASES = {
    "causal": {},
    "window": {"window": 5},
    "qk_norm": {"qk_norm": True},
    "kv_repeat": {"kv_repeat": 2},
    "rope_1e6": {"rope_theta": 1_000_000.0},
    "full": {"causal": False},
}


def _gqa(qk_norm=False, seed=4):
    params, _ = jattn.make_gqa(jax.random.key(seed), D, H, HKV, DH,
                               qk_norm=qk_norm)
    return params, _load(tattn.make_gqa(D, H, HKV, DH, qk_norm), params)


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_forward_matches(case):
    kw = GQA_CASES[case]
    params, p = _gqa(kw.get("qk_norm", False))
    t, j = _pair(_x((2, 11, D)))
    pos = np.arange(11)[None]
    out, cache = tattn.gqa_forward(p, t, positions=torch.from_numpy(pos),
                                   **kw)
    want, wcache = strict_jit(lambda pp, x: jattn.gqa_forward(
        pp, x, positions=jnp.asarray(pos), **kw))(params, j)
    _close(out, want)
    for name in ("k", "v"):
        assert cache[name].shape[2] == HKV * kw.get("kv_repeat", 1)
        _close(cache[name], wcache[name])


class _OnCard:
    """The shape, dtype and device of a tensor on the card, for the route
    rule, which reads nothing else."""

    def __init__(self, b, t, h, d, dtype=torch.bfloat16, device="cuda"):
        self.shape = (b, t, h, d)
        self.dtype, self.device = dtype, torch.device(device)


@pytest.mark.parametrize("t,want", [(512, "kernel"), (1024, "kernel"),
                                    (2048, "kernel"), (3968, "kernel"),
                                    (64, "kernel"), (100, "plain"),
                                    (777, "plain"), (8, "plain")])
def test_prefill_route_by_shape(t, want):
    """qwen3-8b's heads (32 q, 8 kv, d 128): the kernel takes a prompt
    where some config of its space fits (a block_q dividing it with whole
    warpgroups), else the plain formulation runs."""
    kw = {"window": None, "causal": True, "kv_override": None}
    q, k = _OnCard(1, t, 32, 128), _OnCard(1, t, 8, 128)
    assert tattn.prefill_route(q, k, **kw) == want
    assert tattn.prefill_route(q, k, impl="plain", **kw) == "plain"


@pytest.mark.parametrize("case", ["cpu", "f32", "window", "full", "cross",
                                  "d16", "d96", "tq_ne_tk"])
def test_prefill_route_plain_cases(case):
    """Each condition of the rule alone sends an admitted shape to the
    plain formulation: a CPU tensor, f32, a window, no causal mask,
    cross-attention, a head dim the kernel is not built for, Tq != Tk."""
    kw = {"window": None, "causal": True, "kv_override": None}
    q, k = _OnCard(1, 512, 32, 128), _OnCard(1, 512, 8, 128)
    assert tattn.prefill_route(q, k, **kw) == "kernel"
    if case == "cpu":
        q = _OnCard(1, 512, 32, 128, device="cpu")
    elif case == "f32":
        q = _OnCard(1, 512, 32, 128, torch.float32)
    elif case == "window":
        kw["window"] = 1024
    elif case == "full":
        kw["causal"] = False
    elif case == "cross":
        kw["kv_override"] = object()
    elif case in ("d16", "d96"):
        d = int(case[1:])
        q, k = _OnCard(1, 512, 32, d), _OnCard(1, 512, 8, d)
    else:
        k = _OnCard(1, 1024, 8, 128)
    assert tattn.prefill_route(q, k, **kw) == "plain"
    with pytest.raises(ValueError, match="attention_impl"):
        tattn.prefill_route(q, k, impl="sdpa", **kw)


def test_gqa_cross_attention_and_chunked_prefill_match():
    """Cross-attention over an encoder's output (no RoPE on it, no mask),
    and ``opt_attn``'s q-chunked attention at 2048 tokens."""
    params, p = _gqa()
    t, j = _pair(_x((2, 5, D)))
    et, ej = _pair(_x((2, 9, D), 1))
    pos = np.zeros((1, 1), np.int32)
    out, cache = tattn.gqa_forward(p, t, positions=torch.from_numpy(pos),
                                   causal=False, kv_override=et,
                                   rope_theta=0.0, make_cache=False)
    want, _ = strict_jit(lambda pp, x, e: jattn.gqa_forward(
        pp, x, positions=jnp.asarray(pos), causal=False, kv_override=e,
        rope_theta=0.0, make_cache=False))(params, j, ej)
    assert cache is None
    _close(out, want)

    t, j = _pair(_x((1, 2048, D), 2))
    pos = np.arange(2048)[None]
    out, _ = tattn.gqa_forward(p, t, positions=torch.from_numpy(pos),
                               window=300, opt=True, make_cache=False)
    want, _ = strict_jit(lambda pp, x: jattn.gqa_forward(
        pp, x, positions=jnp.asarray(pos), window=300, opt=True,
        make_cache=False))(params, j)
    _close(out, want)


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("case", ["causal", "window", "kv_repeat"])
def test_gqa_decode_matches(case, scatter):
    """One token a slot at per-slot positions into a cache that holds the
    earlier rows, by the one-hot blend or the scatter; a window's ring
    buffer (``insert_at`` = position % rows) past its wrap."""
    kw = {k: v for k, v in GQA_CASES[case].items() if k != "window"}
    r = kw.get("kv_repeat", 1)
    params, p = _gqa()
    rows = 5 if case == "window" else 16
    cache = {n: _x((2, rows, HKV * r, DH), 5 + i)
             for i, n in enumerate(("k", "v"))}
    pos = np.asarray([9, 3])
    ins = pos % rows if case == "window" else None
    t, j = _pair(_x((2, 1, D), 7))
    tcache = {n: torch.from_numpy(v).to(torch.bfloat16)
              for n, v in cache.items()}
    out, new = tattn.gqa_decode(p, t, tcache, position=torch.from_numpy(pos),
                                insert_at=None if ins is None
                                else torch.from_numpy(ins),
                                scatter=scatter, **kw)
    want, wnew = strict_jit(lambda pp, x, c: jattn.gqa_decode(
        pp, x, c, position=jnp.asarray(pos),
        insert_at=None if ins is None else jnp.asarray(ins),
        scatter=scatter, **kw))(params, j, {
            n: jnp.asarray(v, jnp.bfloat16) for n, v in cache.items()})
    _close(out, want)
    for n in ("k", "v"):
        assert np.array_equal(new[n].float().numpy(), as_numpy(wnew[n]))


def test_gqa_decode_blend_and_scatter_write_the_same_cache():
    params, p = _gqa()
    t = torch.from_numpy(_x((3, 1, D), 8)).to(torch.bfloat16)
    cache = {n: torch.from_numpy(_x((3, 12, HKV, DH), 9 + i))
             .to(torch.bfloat16) for i, n in enumerate(("k", "v"))}
    pos = torch.tensor([0, 11, 6])
    blend_out, blend = tattn.gqa_decode(p, t, dict(cache), position=pos)
    scat_out, scat = tattn.gqa_decode(
        p, t, {n: c.clone() for n, c in cache.items()}, position=pos,
        scatter=True)
    assert torch.equal(blend_out, scat_out)
    for n in ("k", "v"):
        assert torch.equal(blend[n], scat[n])
        changed = (blend[n] != cache[n]).any(dim=(2, 3))
        assert changed.sum() <= 3 and not changed[0, 1:].any()


def test_mask_bias_is_finite():
    """The mask adds ``NEG_INF`` = -1e30, not -inf, as the JAX package's."""
    bias = tattn._mask_bias(4, 6, 2, 3, True)
    want = np.asarray(jattn._mask_bias(4, 6, 2, 3, True))
    assert np.array_equal(bias.numpy(), want)
    assert torch.isfinite(bias).all() and bias.min() == -1e30


# --------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------- #
MLA = {"kv_lora": 32, "q_lora": 48, "nope_dim": 16, "rope_dim": 8}


def test_mla_forward_and_absorbed_decode_match():
    params, _ = jattn.make_mla(jax.random.key(6), D, H, **MLA)
    p = _load(tattn.make_mla(D, H, **MLA), params)
    t, j = _pair(_x((2, 10, D)))
    pos = np.arange(10)[None]
    out, cache = tattn.mla_forward(p, t, positions=torch.from_numpy(pos))
    want, wcache = strict_jit(lambda pp, x: jattn.mla_forward(
        pp, x, positions=jnp.asarray(pos)))(params, j)
    _close(out, want)
    for n in ("ckv", "k_pe"):
        _close(cache[n], wcache[n])

    lat = {"ckv": _x((2, 16, MLA["kv_lora"]), 3),
           "k_pe": _x((2, 16, MLA["rope_dim"]), 4)}
    step = np.asarray([10, 4])
    xt, xj = _pair(_x((2, 1, D), 5))
    for scatter in (False, True):
        tl = {n: torch.from_numpy(v).to(torch.bfloat16)
              for n, v in lat.items()}
        out, new = tattn.mla_decode(p, xt, tl,
                                    position=torch.from_numpy(step),
                                    scatter=scatter)
        want, wnew = strict_jit(lambda pp, x, c: jattn.mla_decode(
            pp, x, c, position=jnp.asarray(step), scatter=scatter))(
                params, xj, {n: jnp.asarray(v, jnp.bfloat16)
                             for n, v in lat.items()})
        _close(out, want)
        for n in ("ckv", "k_pe"):
            assert np.array_equal(new[n].float().numpy(), as_numpy(wnew[n]))


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_matches_with_capacity_drops(n_shared):
    """Groups of 16 tokens, 8 experts, top-2, capacity 5 a group: some
    tokens overflow their expert and are dropped, in both packages alike;
    then a decode-time call (one group of the batch, capacity factor 2)."""
    e, dff = 8, 2 * D
    params, _ = jmoe.make_moe(jax.random.key(7), D, dff, e,
                              n_shared=n_shared)
    p = _load(tmoe.make_moe(D, dff, e, n_shared=n_shared), params)
    t, j = _pair(_x((2, 16, D)))
    kw = {"top_k": 2, "capacity_factor": 1.25, "group_size": 16}
    out, aux = tmoe.moe_ffn(p, t, **kw)
    want, waux = strict_jit(lambda pp, x: jmoe.moe_ffn(pp, x, **kw))(
        params, j)
    _close(out, want)
    assert abs(float(aux["aux_loss"]) - float(waux["aux_loss"])) <= 1e-5
    # the capacity dropped someone: a token routed past a full expert
    # gets no contribution from it
    probs = torch.softmax(torch.einsum(
        "gsd,de->gse", t.reshape(2, 16, D).float(), p["router"]), dim=-1)
    idx = torch.topk(probs, 2, dim=-1).indices
    load = torch.stack([torch.bincount(g.flatten(), minlength=e)
                        for g in idx])
    assert (load > int(16 * 2 * 1.25 / e)).any()

    t, j = _pair(_x((3, 1, D), 1))
    kw = {"top_k": 2, "capacity_factor": 2.0, "group_size": 3}
    out, _ = tmoe.moe_ffn(p, t, **kw)
    _close(out, strict_jit(lambda pp, x: jmoe.moe_ffn(pp, x, **kw)[0])(
        params, j))


# --------------------------------------------------------------------- #
# recurrent blocks
# --------------------------------------------------------------------- #
def test_rglru_forward_and_decode_match():
    params, _ = jrglru.make_rglru(jax.random.key(8), D)
    p = _load(trglru.make_rglru(D), params)
    t, j = _pair(_x((2, 12, D)))
    out, state = trglru.rglru_forward(p, t, make_cache=True)
    want, wstate = strict_jit(lambda pp, x: jrglru.rglru_forward(
        pp, x, make_cache=True))(params, j)
    _close(out, want)
    assert state[0].dtype == torch.float32
    _close(state[0], wstate[0])
    _close(state[1], wstate[1])

    xt, xj = _pair(_x((2, 1, D), 1))
    out, new = trglru.rglru_decode(p, xt, state)
    want, wnew = strict_jit(jrglru.rglru_decode)(params, xj, wstate)
    _close(out, want)
    _close(new[0], wnew[0])


def test_rwkv6_forward_over_chunks_and_decode_match():
    """300 tokens: two scan chunks of 150 (``SCAN_CHUNK`` 256 does not
    divide 300); then one decode step from the forward's state."""
    d = 2 * trwkv.HEAD_DIM
    params, _ = jrwkv.make_rwkv6(jax.random.key(9), d)
    p = _load(trwkv.make_rwkv6(d), params)
    t, j = _pair(_x((1, 300, d)))
    out, state = trwkv.rwkv6_forward(p, t, make_cache=True)
    want, wstate = strict_jit(lambda pp, x: jrwkv.rwkv6_forward(
        pp, x, make_cache=True))(params, j)
    _close(out, want)
    assert state[0].dtype == torch.float32 and state[1].dtype == torch.bfloat16
    _close(state[0], wstate[0])
    assert np.array_equal(state[1].float().numpy(), as_numpy(wstate[1]))

    xt, xj = _pair(_x((1, 1, d), 1))
    out, new = trwkv.rwkv6_decode(p, xt, state)
    want, wnew = strict_jit(jrwkv.rwkv6_decode)(params, xj, wstate)
    _close(out, want)
    _close(new[0], wnew[0])
