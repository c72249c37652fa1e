"""The port's mlp, conv and transformer translators against the JAX package's.

On the same weights carried across by ``models.convert`` (and back by the
JAX package's ``hf_convert.convert_translator``): each translator on the
same tokens, float32 atol 1e-4, and each head (MLP at 1-3 layers, the conv
head's three ladders and its pad) atol 1e-4 (tests/test_torch_heads.py's
tolerance: the same math, sums in another order);
``load_theia_checkpoint`` loads each as the JAX loader does. Training
them is held to the JAX package in tests/test_torch_translator_training.py.
Widths are cut (2-layer deit-tiny, translator hidden 8-32) to keep the
CPU time small; the geometry is the published one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import adapter_heads as jheads
from theia_tpu.models import pretrained as jpre
from theia_tpu.models import translators as jtrans
from theia_tpu.models import vit as jvit
from theia_tpu.models.hf_convert import convert_theia_checkpoint
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu_torch.models import adapter_heads as theads
from theia_tpu_torch.models import pretrained as tpre
from theia_tpu_torch.models import translators as ttrans
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import _translator, state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia as TTheia

TINY = "facebook/deit-tiny-patch16-224"
TARGETS = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64)}
# the conv head has no ladder to 14² (the JAX head fails there too)
SIZES = {"mlp": {**TARGETS, "teacher/c.d": (8, 14, 14)}, "conv": TARGETS,
         "transformer": {**TARGETS, "teacher/c.d": (8, 14, 14)}}
KWARGS = {"mlp": dict(translator_hidden_size=32, translator_n_layer=3),
          "conv": dict(translator_hidden_size=8),
          "transformer": dict(translator_hidden_size=32, translator_n_layers=2, translator_n_heads=4)}
TRANSLATORS = list(KWARGS)
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def two_layer_backbones():
    saved = [(configs, configs[TINY]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[TINY] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, cfg in saved:
        configs[TINY] = cfg


def _port_translator(t, sizes, params, source=(192, 14, 14)):
    tt = ttrans.build_feature_translator(t, backbone_feature_size=source, target_feature_sizes=sizes, **KWARGS[t])
    sd = _translator(params, sizes, source[1], t)
    tt.load_state_dict({k.removeprefix("translator."): torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()},
                       strict=True)
    return tt


@pytest.mark.parametrize("no_cls", [False, True])
@pytest.mark.parametrize("t", TRANSLATORS)
def test_translator_matches_jax(t, no_cls):
    sizes = SIZES[t]
    tokens = RNG.standard_normal((2, 196 + (0 if no_cls else 1), 192), dtype=np.float32)
    jt = jtrans.build_feature_translator(t, backbone_feature_size=(192, 14, 14), target_feature_sizes=sizes,
                                         dtype=jnp.float32, **KWARGS[t])
    params = jt.init(jax.random.PRNGKey(1), jnp.asarray(tokens), None, no_cls)["params"]
    want = jt.apply({"params": params}, jnp.asarray(tokens), None, no_cls)
    with torch.no_grad():
        got = _port_translator(t, sizes, params)(torch.from_numpy(tokens), backbone_no_cls=no_cls)
    assert list(got) == list(sizes)
    for name, (c, h, w) in sizes.items():
        assert tuple(got[name].shape) == (2, h * w, c)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-4, rtol=0, err_msg=name)


HEADS = [
    ("mlp", 1, (16, 14, 14), (24, 16, 16)),  # nearest 14 -> 16, one Linear
    ("mlp", 2, (16, 14, 14), (12, 64, 64)),  # nearest 14 -> 64
    ("mlp", 3, (16, 14, 14), (8, 14, 14)),  # no resize
    ("conv", None, (16, 16, 16), (12, 64, 64)),  # 16 -> 31 -> 64, ConvTranspose at 1, 4 and 7
    ("conv", None, (16, 16, 16), (24, 16, 16)),  # convs
    ("conv", None, (16, 64, 64), (24, 16, 16)),  # strided convs
    ("conv", None, (16, 14, 14), (24, 16, 16)),  # pad 14 -> 16, then convs
    ("conv", None, (16, 12, 12), (12, 64, 64)),  # pad 12 -> 16, then the ladder up
]


@pytest.mark.parametrize("kind, num_layer, source, target", HEADS)
def test_head_matches_jax(kind, num_layer, source, target):
    s = source[1]
    tokens = RNG.standard_normal((2, s * s + 1, source[0]), dtype=np.float32)
    if kind == "mlp":
        jh = jheads.MLPAdapterHead(source, target, num_layer=num_layer)
        th = theads.MLPAdapterHead(source, target, num_layer)
    else:
        jh = jheads.ConvAdapterHead(source, target)
        th = theads.ConvAdapterHead(source, target)
    params = jh.init(jax.random.PRNGKey(2), jnp.asarray(tokens))["params"]
    want = np.asarray(jh.apply({"params": params}, jnp.asarray(tokens)))
    prefix = "translator.translator_heads.t."
    sd = _translator({"head_t": params}, {"t": target}, s, kind)
    th.load_state_dict({k.removeprefix(prefix): torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = th(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, target[1] * target[2], target[0])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("source, target", [((16, 32, 32), (24, 16, 16)), ((16, 10, 10), (24, 16, 16)),
                                            ((16, 14, 14), (24, 14, 14)), ((16, 16, 16), (24, 32, 32))])
def test_conv_head_unsupported_geometries_raise(source, target):
    with pytest.raises(NotImplementedError):
        theads.ConvAdapterHead(source, target)


def _jax_theia(t, sizes, **kw):
    return JTheia(backbone=TINY, translator=t, target_feature_sizes=sizes, translator_kwargs=KWARGS[t], **kw)


def _jax_params(t, sizes, seed=0):
    return _jax_theia(t, sizes).init(jax.random.PRNGKey(seed), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]


def _port_theia(t, sizes, **kw):
    return TTheia(backbone=TINY, translator=t, target_feature_sizes=sizes, translator_kwargs=KWARGS[t], **kw)


def _leaves_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("t", TRANSLATORS)
def test_carry_across_inverts_convert_translator(t):
    """JAX params -> the port's state dict (which its model loads strictly)
    -> the JAX package's converter -> the same params, leaf for leaf."""
    sizes = SIZES[t]
    params = _jax_params(t, sizes)
    sd = state_dict_from_jax(params, sizes, translator=t)
    _port_theia(t, sizes).load_state_dict(sd, strict=True)
    back = convert_theia_checkpoint({k: v.numpy() for k, v in sd.items()}, num_layers=2, translator_type=t,
                                    target_feature_sizes=sizes)
    _leaves_equal(back, jax.tree.map(np.asarray, params))


def test_build_feature_translator_dispatch():
    kw = dict(backbone_feature_size=(16, 14, 14), target_feature_sizes={"a": (8, 16, 16)})
    assert isinstance(ttrans.build_feature_translator("mlp", hidden_size=4, **kw), ttrans.MLPFeatureTranslator)
    assert isinstance(ttrans.build_feature_translator("conv", **kw), ttrans.ConvFeatureTranslator)
    assert isinstance(ttrans.build_feature_translator("lconv", **kw), ttrans.LightConvFeatureTranslator)
    for name in ("transformer", "trans"):
        m = ttrans.build_feature_translator(name, translator_activation="gelu", translator_hidden_size=16,
                                            translator_n_heads=2, **kw)
        assert isinstance(m, ttrans.TransformerFeatureTranslator)
    with pytest.raises(NotImplementedError):
        ttrans.build_feature_translator("unknown", **kw)


def test_transformer_free_parameters_are_drawn_after_to_empty():
    """``Theia.reset_parameters`` after ``to_empty`` draws the decode tokens,
    the teacher embeddings and the packed projections as the JAX init does."""
    sizes = SIZES["transformer"]
    with torch.device("meta"):
        model = _port_theia("transformer", sizes)
    model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    tr = model.translator
    hidden = KWARGS["transformer"]["translator_hidden_size"]
    tokens = tr.decode_tokens.detach()
    assert abs(float(tokens.std()) - 1.0) < 0.05 and abs(float(tokens.mean())) < 0.05
    embs = torch.cat([p.detach().flatten() for p in tr.target_model_emb.values()])
    assert bool(torch.isfinite(embs).all()) and float(embs.std()) > 0.5 and len(set(embs.tolist())) == len(embs)
    attn = tr.translator_stem.layers[0].self_attn
    w = attn.in_proj_weight.detach()
    assert float(w.abs().max()) <= (1.0 / hidden) ** 0.5 and float(w.std()) > 0
    assert not attn.in_proj_bias.any()
    again = _port_theia("transformer", sizes)
    again.reset_parameters(torch.Generator().manual_seed(0))
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("t", TRANSLATORS)
def test_load_theia_checkpoint_matches_jax(tmp_path, t):
    """A reference-layout file of each translator loads into the port's model
    as the JAX loader loads it: every tensor equal."""
    sizes = SIZES[t]
    path = str(tmp_path / "ckpt.pth")
    torch.save(state_dict_from_jax(_jax_params(t, sizes, seed=5), sizes, translator=t), path)
    jloaded = jpre.load_theia_checkpoint(path, _jax_theia(t, sizes))
    model = _port_theia(t, sizes)
    assert tpre.load_theia_checkpoint(path, model) is model
    want = state_dict_from_jax(jax.tree.map(np.asarray, jloaded), sizes, translator=t)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_load_theia_checkpoint_without_the_conv_pad(tmp_path):
    """The conv heads' ``pad`` is optional in a file, as in the JAX
    converter, which then reads such a head on the 14x14 grid: the 16x16
    ladder's convolutions as transposed ones, keeping the model's init where
    the shapes then differ. The port loads the file as the JAX loader does,
    from the same initial parameters (the JAX loader's ``PRNGKey(0)`` init):
    every tensor equal, the pads the init's."""
    sizes = SIZES["conv"]
    sd = {k: v for k, v in state_dict_from_jax(_jax_params("conv", sizes, seed=5), sizes, translator="conv").items()
          if ".pad.1." not in k}
    path = str(tmp_path / "nopad.pth")
    torch.save(sd, path)
    jloaded = jpre.load_theia_checkpoint(path, _jax_theia("conv", sizes))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jloaded), sizes, translator="conv")
    model = _port_theia("conv", sizes)
    model.load_state_dict(state_dict_from_jax(_jax_params("conv", sizes), sizes, translator="conv"), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    tpre.load_theia_checkpoint(path, model)
    got = model.state_dict()
    assert set(got) == set(want) == set(sd) | {k for k in got if ".pad.1." in k}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    swapped = "translator.translator_heads.teacher/a.adapter.4.weight"  # hidden -> hidden, 16x16
    assert torch.equal(got[swapped], sd[swapped].transpose(0, 1))
    assert torch.equal(got["translator.translator_heads.teacher/a.adapter.1.weight"],
                       init["translator.translator_heads.teacher/a.adapter.1.weight"])


# the conv translator's LayerNormSpatial sites (C, side) at its configured
# width (hidden 1024, the heads' 2048), which the lconv recipe never gave K3/K4
CONV_LN_SHAPES = [(1024, 16), (2048, 16), (2048, 31), (2048, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, side", CONV_LN_SHAPES)
def test_cuda_ln_bwd_at_conv_translator_shapes(cuda, c, side, dtype):
    """K3 and K4 at [16, C, side, side] against their plain versions: K3's
    sums within relative L2 1e-5 of the plain version in float64, K4's dx
    within 1e-5 (float32) or 1e-2 (bf16) of the plain dx, one launch each."""
    from theia_tpu_torch.ops import ln_pallas as tln

    gen = torch.Generator().manual_seed(c + side)
    x = (torch.randn(16, c, side, side, generator=gen) * 2 + 1).to(cuda, dtype)
    g = torch.randn(16, c, side, side, generator=gen).to(cuda, dtype)
    x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    w = torch.randn(c, side, side, generator=gen).to(cuda)
    mean, r = tln.ln_spatial_stats(x, 1e-5)
    before = (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES)
    got = tln.ln_bwd_stats(x, w, mean, r, g)
    dx = tln.ln_bwd_dx(x, w, mean, r, g, got[0], got[1])
    torch.cuda.synchronize()
    assert (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
    for a, b in zip(got, want):
        assert _rel_l2(a, b) < 1e-5
    want_dx = tln.ln_bwd_dx_plain(x, w, mean, r, g, got[0], got[1])
    assert _rel_l2(dx.float(), want_dx.float()) < (1e-5 if dtype == torch.float32 else 1e-2)
