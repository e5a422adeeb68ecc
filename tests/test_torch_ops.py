"""The port's public ops at shapes their ``DEFAULT_CONFIG`` does not fit,
against the JAX package's ops at the same shapes.

With no config from the caller, each op runs its default where the kernel's
space admits it at the call's shape, else the admitted config nearest to it
(``kernels.common.resolve_config``, cached per shape).  Where no config fits, the CPU runs
the plain version with the default's blocks over a ragged last tile and a
CUDA tensor raises.  Off the TPU the JAX ops return their oracle's answer
at any shape, so here both packages answer, and they must agree within
the JAX package's tolerances (``tests/test_kernels.py`` ``TOLS``, the f32
column: every default here is f32).  An explicit config that does not fit
still raises (each kernel's ``test_dispatch_raises_...``).

Inputs are drawn with numpy from a seed by each problem's
``numpy_inputs``, and handed to both packages as the same values: bf16 for
GEMM and attention, f32 for the others.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import ops as jattention  # noqa: E402
from repro.kernels.conv2d import ops as jconv2d  # noqa: E402
from repro.kernels.dedisp import ops as jdedisp  # noqa: E402
from repro.kernels.expdist import ops as jexpdist  # noqa: E402
from repro.kernels.hotspot import ops as jhotspot  # noqa: E402
from repro.kernels.matmul import ops as jgemm  # noqa: E402
from repro.kernels.nbody import ops as jnbody  # noqa: E402
from repro.kernels.pnpoly import ops as jpnpoly  # noqa: E402
from repro_torch.kernels.attention import ops as attention  # noqa: E402
from repro_torch.kernels.attention.space import \
    build_space as attention_space  # noqa: E402
from repro_torch.kernels.attention.space import \
    numpy_inputs as attention_inputs  # noqa: E402
from repro_torch.kernels.common import (admits, config_at,  # noqa: E402
                                        inputs_from_numpy)
from repro_torch.kernels.conv2d import ops as conv2d  # noqa: E402
from repro_torch.kernels.conv2d.space import \
    build_space as conv2d_space  # noqa: E402
from repro_torch.kernels.conv2d.space import \
    numpy_inputs as conv2d_inputs  # noqa: E402
from repro_torch.kernels.dedisp import ops as dedisp  # noqa: E402
from repro_torch.kernels.dedisp.space import \
    build_space as dedisp_space  # noqa: E402
from repro_torch.kernels.dedisp.space import \
    numpy_inputs as dedisp_inputs  # noqa: E402
from repro_torch.kernels.expdist import ops as expdist  # noqa: E402
from repro_torch.kernels.expdist.space import \
    build_space as expdist_space  # noqa: E402
from repro_torch.kernels.expdist.space import \
    numpy_inputs as expdist_inputs  # noqa: E402
from repro_torch.kernels.hotspot import ops as hotspot  # noqa: E402
from repro_torch.kernels.hotspot.space import \
    build_space as hotspot_space  # noqa: E402
from repro_torch.kernels.hotspot.space import \
    numpy_inputs as hotspot_inputs  # noqa: E402
from repro_torch.kernels.matmul import ops as gemm  # noqa: E402
from repro_torch.kernels.matmul.space import \
    build_space as gemm_space  # noqa: E402
from repro_torch.kernels.matmul.space import \
    numpy_inputs as gemm_inputs  # noqa: E402
from repro_torch.kernels.nbody import ops as nbody  # noqa: E402
from repro_torch.kernels.nbody.space import \
    build_space as nbody_space  # noqa: E402
from repro_torch.kernels.nbody.space import \
    numpy_inputs as nbody_inputs  # noqa: E402
from repro_torch.kernels.pnpoly import ops as pnpoly  # noqa: E402
from repro_torch.kernels.pnpoly.space import \
    build_space as pnpoly_space  # noqa: E402
from repro_torch.kernels.pnpoly.space import \
    numpy_inputs as pnpoly_inputs  # noqa: E402

#: tests/test_kernels.py TOLS, the f32 column
TOLS = {"gemm": 5e-3, "conv2d": 5e-3, "nbody": 1e-3, "hotspot": 5e-3,
        "pnpoly": 0.0, "expdist": 1e-3, "dedisp": 1e-3, "attention": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; one torch thread each
    keeps them from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def both(arrays: dict, bf16: bool):
    """The same values as torch CPU tensors and as jnp arrays."""
    if bf16:
        t = inputs_from_numpy(arrays, device="cpu")
        j = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
             if isinstance(v, torch.Tensor) else v for k, v in t.items()}
        return t, j
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in arrays.items()}
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in arrays.items()}
    return t, j


def resolved(mod, build_space, **shape):
    """The config ``mod``'s op runs at ``shape`` when its caller names
    none, or None where no config of the space fits."""
    return config_at(build_space, shape, mod.DEFAULT_CONFIG, mod.SEMANTIC)


def _gemm(shape):
    t, j = both(gemm_inputs(1, *shape), bf16=True)
    args = ("a", "b", "c", "alpha", "beta")
    m, n, k = shape
    return (gemm, resolved(gemm, gemm_space, m=m, n=n, k=k),
            gemm.gemm(*(t[k] for k in args)),
            jgemm.gemm(*(j[k] for k in args)))


def _attention(shape, causal=True):
    t, j = both(attention_inputs(1, *shape), bf16=True)
    hq, hkv, tq, tk, d = shape
    return (attention, resolved(attention, attention_space, hq=hq, hkv=hkv,
                                tq=tq, tk=tk, d=d),
            attention.attention(t["q"], t["k"], t["v"], causal=causal),
            jattention.attention(j["q"], j["k"], j["v"], causal=causal))


def _nbody(n):
    t, j = both(nbody_inputs(1, n), bf16=False)
    return (nbody, resolved(nbody, nbody_space, n=n),
            nbody.nbody(t["pos"], t["mass"]),
            jnbody.nbody(j["pos"], j["mass"]))


def _pnpoly(n, v):
    t, j = both(pnpoly_inputs(1, n, v), bf16=False)
    return (pnpoly, resolved(pnpoly, pnpoly_space, n=n, v=v),
            pnpoly.pnpoly(t["points"], t["poly"]),
            jpnpoly.pnpoly(j["points"], j["poly"]))


def _conv2d(h, w, fh, fw):
    t, j = both(conv2d_inputs(1, h, w, fh, fw), bf16=False)
    return (conv2d, resolved(conv2d, conv2d_space, h=h, w=w, fh=fh, fw=fw),
            conv2d.conv2d(t["image"], t["filt"]),
            jconv2d.conv2d(j["image"], j["filt"]))


def _hotspot(h, w, n):
    t, j = both(hotspot_inputs(1, h, w, n), bf16=False)
    fits = admits(hotspot_space(), hotspot.DEFAULT_CONFIG)
    return (hotspot, hotspot.DEFAULT_CONFIG if fits else None,
            hotspot.hotspot(t["temp"], t["power"], t["n_sweeps"]),
            jhotspot.hotspot(j["temp"], j["power"], j["n_sweeps"]))


def _expdist(ka, kb):
    t, j = both(expdist_inputs(1, ka, kb), bf16=False)
    args = ("a", "b", "sa", "sb")
    return (expdist, resolved(expdist, expdist_space, kb=kb),
            expdist.expdist(*(t[k] for k in args)),
            jexpdist.expdist(*(j[k] for k in args)))


def _dedisp(c, d, t_out, t_in, dm_step):
    t, j = both(dedisp_inputs(1, c, d, t_out, t_in, dm_step), bf16=False)
    return (dedisp, resolved(dedisp, dedisp_space, d=d, t_out=t_out,
                             t_in=t_in, c=c),
            dedisp.dedisp(t["x"], t["delays"], t_out),
            jdedisp.dedisp(j["x"], j["delays"], t_out))


#: per op, a shape its default does not fit, and the JAX op takes: a config
#: nearer the default runs (``resolved``).  hotspot's space does not depend
#: on the shape, so its default fits every shape and its op runs it with no
#: resolving; dedisp's default (a block of 8 DMs) fits the small shapes, its
#: ring the widest T - t_out of its cases.  Their cases hold that the space
#: admits it at a small shape (``default``).
OP_CASES = {
    "gemm": (lambda: _gemm((192, 64, 320)), "resolved"),
    "attention": (lambda: _attention((4, 2, 32, 96, 64)), "resolved"),
    "nbody": (lambda: _nbody(384), "resolved"),
    "pnpoly": (lambda: _pnpoly(1000, 5), "resolved"),
    "conv2d": (lambda: _conv2d(20, 60, 5, 5), "resolved"),
    "hotspot": (lambda: _hotspot(8, 24, 3), "default"),
    "expdist": (lambda: _expdist(300, 500), "resolved"),
    "dedisp": (lambda: _dedisp(6, 4, 64, 128, 0.5), "default"),
}


@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_answers_where_its_default_does_not_fit(name):
    run, kind = OP_CASES[name]
    mod, cfg, got, want = run()
    assert cfg is not None
    if kind == "default":
        assert cfg == mod.DEFAULT_CONFIG
    else:
        assert cfg != mod.DEFAULT_CONFIG
    assert rel_l2(as_np(got), as_np(want)) <= TOLS[name]


def test_gemm_at_128_cubed_with_no_config():
    mod, cfg, got, want = _gemm((128, 128, 128))
    # the default's 256 x 128 tile does not fit: its 128 x 128 neighbour
    assert cfg == dict(gemm.DEFAULT_CONFIG, block_m=128)
    assert rel_l2(as_np(got), as_np(want)) <= TOLS["gemm"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_with_ragged_tiles(causal):
    """Tq = Tk = 100: no block_q or block_kv of the menu divides it, so no
    config fits; the CPU runs the plain version with the default's blocks
    over a ragged last q tile and kv tile."""
    _, cfg, got, want = _attention((4, 2, 100, 100, 64), causal)
    assert cfg is None
    assert got.shape == (4, 100, 64) and torch.isfinite(got).all()
    assert rel_l2(as_np(got), as_np(want)) <= TOLS["attention"]


#: shapes no config of the space fits, which the CPU runs by the plain
#: version with the default: M = 100 (no block_m divides it), 100 bodies
#: (no block divides them), an output 6 wide (narrower than any block_w)
NO_FIT = {
    "gemm": (lambda: _gemm((100, 72, 136)), "gemm"),
    "nbody": (lambda: _nbody(100), "nbody"),
    "conv2d": (lambda: _conv2d(24, 20, 15, 15), "conv2d"),
}


@pytest.mark.parametrize("name", list(NO_FIT))
def test_op_answers_where_no_config_fits(name):
    run, tol = NO_FIT[name]
    _, cfg, got, want = run()
    assert cfg is None
    assert rel_l2(as_np(got), as_np(want)) <= TOLS[tol]


def test_the_config_is_resolved_once_a_shape():
    """A second call at the same shape takes the cached config: the space
    is built once."""
    config_at.cache_clear()
    t, _ = both(gemm_inputs(2, 128, 128, 128), bf16=True)
    args = (t["a"], t["b"], t["c"], t["alpha"], t["beta"])
    first = gemm.gemm(*args)
    second = gemm.gemm(*args)
    info = config_at.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert torch.equal(first, second)
    assert resolved(gemm, gemm_space, m=128, n=128, k=128) \
        is resolved(gemm, gemm_space, m=128, n=128, k=128)


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on a card: the op must refuse it before
    it reaches anything of CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_no_fit_attention_raises_on_cuda_naming_the_shape():
    t, _ = both(attention_inputs(1, 4, 2, 100, 100, 64), bf16=True)
    q, k, v = (t[n].as_subclass(FakeCuda) for n in ("q", "k", "v"))
    assert q.device.type == "cuda"
    before = attention.attention.launches
    with pytest.raises(ValueError,
                       match="hq=4, hkv=2, tq=100, tk=100, d=64"):
        attention.attention(q, k, v)
    assert attention.attention.launches == before
