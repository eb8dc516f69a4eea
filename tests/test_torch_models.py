"""The surrogate's models and PCA of the PyTorch port against the JAX
package on the CPU: `models.mlp` (`ARCH_TABLE`, `define_model_arch`,
`ModelDef.from_arch`, `apply_model` for the dense, attention and conv1d
models, `l2_penalty`, `count_params`, a bundle of each kind loaded from a
JAX-written directory) and `surrogate.pca.PCAModel`'s bf16 encode and
decode.

The parameters come from JAX's `init_model` through `np.asarray` and
`params_from_numpy`; the inputs are seeded with numpy. Tolerances, max
|port - JAX| / max |JAX|:
- float32 compute: 1e-5 (products summed in another order);
- bfloat16 compute: 2e-2. The dense and attention products round to
  bf16 in both packages, and an input that differs in its last float32
  bit can round to the neighbouring bf16 value (2^-8 apart), which the
  following layers carry;
- the bf16 PCA: 1e-5. Both packages round the operands to bf16 and sum
  the products in float32 without rounding the result again, so only
  the order of the float32 sums differs;
- l2_penalty: 1e-6; counts, tables and parameter trees: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.models import mlp as jmlp
from tpufoam.surrogate import pca as jpca
from tpufoam_torch.models import mlp as tmlp
from tpufoam_torch.surrogate import pca as tpca
from tpufoam_torch.surrogate import pipeline as tpipe

F32_TOL = 1e-5
BF16_TOL = 2e-2
PCA_TOL = 1e-5
KINDS = {"dense": "MLP_small", "attention": "MLP_attention",
         "conv1d": "conv1D"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


def _models(arch, cdt, seed=1, in_dim=13, out_dim=40):
    jdef = jmlp.ModelDef.from_arch(arch, in_dim=in_dim, out_dim=out_dim,
                                   compute_dtype=cdt)
    params = jmlp.init_model(jax.random.PRNGKey(seed), jdef)
    tdef = tmlp.ModelDef.from_arch(arch, in_dim=in_dim, out_dim=out_dim,
                                   compute_dtype=cdt)
    tparams = tmlp.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jdef, params, tdef, tparams


def test_arch_table_and_from_arch_equal_jax():
    assert tmlp.ARCH_TABLE == jmlp.ARCH_TABLE
    for name in jmlp.ARCH_TABLE:
        assert tmlp.define_model_arch(name) == jmlp.define_model_arch(name)
        jd = jmlp.ModelDef.from_arch(name, in_dim=7, out_dim=9, l2=1e-4)
        td = tmlp.ModelDef.from_arch(name, in_dim=7, out_dim=9, l2=1e-4)
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    for mod in (tmlp, jmlp):
        with pytest.raises(ValueError):
            mod.define_model_arch("MLP_nonexistent")


@pytest.mark.parametrize("cdt,rtol", [("float32", F32_TOL),
                                      ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_model_matches_jax(kind, cdt, rtol):
    jdef, params, tdef, tparams = _models(KINDS[kind], cdt)
    # non-zero biases and LayerNorm gains, so that every parameter enters
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, params)
    tparams = tmlp.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    x = rng.standard_normal((16, 13)).astype(np.float32)
    ref = jmlp.apply_model(params, jdef, jnp.asarray(x))
    got = tmlp.apply_model(tparams, tdef, T(x))
    assert got.dtype == torch.float32
    close(got, ref, rtol, f"{kind} {cdt}")


@pytest.mark.parametrize("kind", list(KINDS))
def test_l2_penalty_and_count_params_match_jax(kind):
    _, params, _, tparams = _models(KINDS[kind], "float32", seed=3)
    assert tmlp.count_params(tparams) == jmlp.count_params(params)
    close(tmlp.l2_penalty(tparams), jmlp.l2_penalty(params), 1e-6)


def test_unknown_kind_raises():
    tdef = tmlp.ModelDef(kind="rnn", widths=(8,), in_dim=4, out_dim=2)
    with pytest.raises(ValueError):
        tmlp.apply_model({}, tdef, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        tmlp.param_skeleton(tdef)


@pytest.mark.parametrize("kind", ["attention", "conv1d"])
def test_bundle_of_each_kind_loads_from_jax(kind, tmp_path):
    """A JAX-written bundle with the attention or conv1d model: the port's
    loader rebuilds the parameter tree from the flat leaves, and the
    forward matches."""
    from tpufoam.surrogate.pipeline import SurrogateBundle as JBundle
    jb = _tiny_bundle(block_size=16)
    jdef = jmlp.ModelDef.from_arch(KINDS[kind], in_dim=jb.pc_in,
                                   out_dim=jb.pc_out)
    jb = dataclasses.replace(jb, mdef=jdef,
                             params=jmlp.init_model(jax.random.PRNGKey(5),
                                                    jdef))
    jb.save(str(tmp_path))
    jb = JBundle.load(str(tmp_path))
    tb = tpipe.SurrogateBundle.load(str(tmp_path), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jb.params):
        node = tb.params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    x = np.random.default_rng(6).standard_normal((8, jb.pc_in)).astype(
        np.float32)
    close(tmlp.apply_model(tb.params, tb.mdef, T(x)),
          jmlp.apply_model(jb.params, jb.mdef, jnp.asarray(x)), BF16_TOL)


def _pcas(d=3 * 16 * 16, k=24, seed=8):
    rng = np.random.default_rng(seed)
    comp = np.linalg.qr(rng.standard_normal((d, k)))[0].T.astype(np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    ev = np.linspace(1.0, 0.1, k).astype(np.float32)
    jp = jpca.PCAModel(mean=jnp.asarray(mean), components=jnp.asarray(comp),
                       explained_variance=jnp.asarray(ev),
                       explained_variance_ratio=jnp.asarray(ev / ev.sum()))
    tp = tpca.PCAModel(T(mean), T(comp), T(ev), T(ev / ev.sum()))
    return rng, jp, tp


def test_pca_bf16_transform_matches_jax():
    rng, jp, tp = _pcas()
    x = rng.standard_normal((10, jp.components.shape[1])).astype(np.float32)
    ref = jp.transform(jnp.asarray(x), 20, dtype=jnp.bfloat16)
    got = tp.transform(T(x), 20, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    close(got, ref, PCA_TOL, "transform")
    # the result is not rounded to bf16: it differs from the f32 product
    # by the operands' rounding only, and is not a bf16 grid value
    f32 = tp.transform(T(x), 20)
    assert float((got - f32).abs().max()) < 2e-2 * float(f32.abs().max())
    assert not torch.equal(got, got.bfloat16().float())
    z = rng.standard_normal((10, 20)).astype(np.float32)
    close(tp.inverse_transform(T(z), dtype=torch.bfloat16),
          jp.inverse_transform(jnp.asarray(z), dtype=jnp.bfloat16), PCA_TOL,
          "inverse_transform")
    # bases already in bf16 (the predictor casts them once) give the same
    tb = dataclasses.replace(tp, components=tp.components.bfloat16())
    assert torch.equal(tb.transform(T(x), 20, dtype=torch.bfloat16), got)


def test_pca_bf16_products_sum_in_float32():
    """The CPU form is the float32 product of the bf16-rounded operands."""
    rng, _, tp = _pcas()
    x = T(rng.standard_normal((4, tp.components.shape[1])).astype(
        np.float32))
    want = ((x - tp.mean).bfloat16().float()
            @ tp.components.bfloat16().float().T)
    assert torch.equal(tp.transform(x, dtype=torch.bfloat16), want)
