"""The port's downstream modules against the JAX package's, on the CPU:
the CortexBench transforms, ``load_model``, the policy heads and the
TriFinger policy (``utils/cortexbench``), and the baseline VFM encoders
(``models/vfm.py``), on weights carried across from flax params
(``models.convert``).

Tolerances:
  - transforms: float outputs rtol 1e-5, atol 1e-5 (the resize's float32
    sums in another order); uint8 outputs equal but where the resized value
    lies on a .5 tie, which float32 sums in another order round either way:
    one uint8 step, at most 0.01% of the values (1 in ~150,000 seen, each
    at x.49998 against x.5);
  - ``load_model``'s features: atol 1e-3, the serving tolerance of
    tests/test_torch_serving.py (preprocessing rounding flips);
  - policy heads: forward atol 1e-5; gradients of every parameter against
    ``jax.grad`` within 1e-4 (max abs over the tensor's max abs, + 1e-6);
  - VFM encoders: tests/test_torch_teachers.py's float32 rule (max abs
    error at most 1e-5 of max |want| + 1e-6), at image sizes where the
    towers' processors do not resample.
The JAX ``ConvBatchNormMLP`` cannot make its ``log_std`` parameter (flax
refuses a parameter outside ``setup`` or a compact method), so the port's
``log_std`` is held to its definition, max(init_log_std, min_log_std).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.foundation import clip as jclip
from theia_tpu.foundation import dinov2 as jdinov2
from theia_tpu.foundation import sam as jsam
from theia_tpu.foundation import towers as jtowers
from theia_tpu.foundation import vit as jfvit
from theia_tpu.models import vfm as jvfm
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.utils.cortexbench.load_model import load_model as jload_model
from theia_tpu.utils.cortexbench import policy_heads as jheads
from theia_tpu.utils.cortexbench import transforms as jtransforms
from theia_tpu.utils.cortexbench.trifinger import policy as jtrifinger
from theia_tpu_torch.foundation import clip as tclip
from theia_tpu_torch.foundation import dinov2 as tdinov2
from theia_tpu_torch.foundation import sam as tsam
from theia_tpu_torch.foundation import vit as tfvit
from theia_tpu_torch.models import convert
from theia_tpu_torch.models import vfm as tvfm
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.utils.cortexbench.load_model import load_model as tload_model
from theia_tpu_torch.utils.cortexbench import policy_heads as theads
from theia_tpu_torch.utils.cortexbench import transforms as ttransforms
from theia_tpu_torch.utils.cortexbench.trifinger import policy as ttrifinger

TINY = "facebook/deit-tiny-patch16-224"
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, patch_size=16, image_size=224)


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def _perturb(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)), params)


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("name", ["rvfm_image_transforms", "vit_transforms", "r3m_transforms"])
@pytest.mark.parametrize("shape", [(100, 120, 3), (131, 97, 3), (257, 301, 3)])
def test_transforms_match_jax(name, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    want = getattr(jtransforms, name)()(img)
    got = getattr(ttransforms, name)()(img)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- load_model


@pytest.fixture
def two_layer_tiny(monkeypatch):
    for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS):
        monkeypatch.setitem(configs, TINY, dataclasses.replace(configs[TINY], num_layers=2))


def test_load_model_matches_jax(two_layer_tiny, tmp_path):
    jmodel = JTheia(backbone=TINY, translator="lconv")
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8),
                         method=jmodel.forward_feature)["params"]
    model = TTheia(backbone=TINY, translator="lconv", target_feature_sizes={})
    model.load_state_dict(convert.state_dict_from_jax(params, {}), strict=True)
    jfwd, jdim, _, _ = jload_model(jmodel, params, jtransforms.rvfm_image_transforms())
    fwd, dim, transform, meta = tload_model(model.eval(), ttransforms.rvfm_image_transforms(), "meta")
    assert dim == jdim == (192, 14, 14) and meta == "meta"
    img = np.random.RandomState(3).randint(0, 256, (150, 170, 3), np.uint8)
    batch = transform(img)[None]
    got = fwd(batch)
    assert isinstance(got, torch.Tensor) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jfwd(jnp.asarray(batch))), atol=1e-3, rtol=0)
    # checkpoint_path loads the weights into the model first
    torch.save(model.state_dict(), tmp_path / "student.pth")
    other = TTheia(backbone=TINY, translator="lconv", target_feature_sizes={})
    fwd2, dim2, _, _ = tload_model(other.eval(), transform, checkpoint_path=str(tmp_path / "student.pth"))
    assert dim2 == dim and torch.equal(fwd2(batch), got)


# ------------------------------------------------------------- policy heads


def _head_pair(jmodule, tmodule, obs, seed):
    jparams = _perturb(jax.jit(jmodule.init)(jax.random.PRNGKey(seed), jnp.asarray(obs))["params"], seed)
    tmodule.load_state_dict(convert.policy_state_dict(jparams, log_std=tmodule.state_dict().get("log_std_param")),
                            strict=True)
    return jparams


def _check_forward_and_grads(jmodule, jparams, tmodule, obs):
    want = np.asarray(jax.jit(jmodule.apply)({"params": jparams}, jnp.asarray(obs)))
    x = torch.from_numpy(obs).requires_grad_(True)
    got = tmodule(x)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    r = np.random.RandomState(9).standard_normal(want.shape).astype(np.float32)

    def loss(p, o):
        return jnp.sum(jmodule.apply({"params": p}, o) * r)

    jg, jx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jparams, jnp.asarray(obs))
    (got * torch.from_numpy(r)).sum().backward()
    wgrads = convert.policy_state_dict(jg)
    for n, p in tmodule.named_parameters():
        if n in wgrads:
            _close(p.grad, wgrads[n], rel=1e-4)
    _close(x.grad, jx, rel=1e-4)


def test_conv_batchnorm_mlp_matches_jax():
    c, h, w, t, proprio, a = 8, 14, 14, 3, 9, 4
    jm = jheads.ConvBatchNormMLP(embedding_dim=(c, h, w), proprio_dim=proprio, history_window=t, action_dim=a)
    tm = theads.ConvBatchNormMLP(embedding_dim=(c, h, w), proprio_dim=proprio, history_window=t, action_dim=a,
                                 init_log_std=-4.0)
    obs = np.random.RandomState(0).randn(3, t * h * w * c + proprio).astype(np.float32)
    jparams = _head_pair(jm, tm, obs, 0)
    _check_forward_and_grads(jm, jparams, tm, obs)
    assert torch.equal(tm.log_std(), torch.full((a,), -3.0))  # max(init_log_std, min_log_std)
    apply_fn = jax.jit(lambda p, o: jm.apply({"params": p}, o))
    want, winfo = jheads.get_action(apply_fn, jparams, obs[0], np.random.RandomState(1), log_std=-0.5)
    got, info = theads.get_action(tm, obs[0], np.random.RandomState(1), log_std=-0.5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(info["mean"], winfo["mean"], atol=1e-5)
    np.testing.assert_allclose(got - info["mean"], want - winfo["mean"], atol=1e-6)  # the same noise draws
    want, _ = jheads.get_action_deterministic(apply_fn, jparams, obs[1])
    got, info = theads.get_action_deterministic(tm, obs[1])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert info["log_std"] == 0


def test_conv_batchnorm_mlp_channels_are_c_major_then_t():
    """b (t h w c) -> b (c t) h w: input channel k of the first conv is
    feature channel k // T of frame k % T."""
    c, t = 3, 2
    tm = theads.ConvBatchNormMLP(embedding_dim=(c, 14, 14), proprio_dim=0, history_window=t, action_dim=2)
    emb = torch.arange(t * 14 * 14 * c, dtype=torch.float32)[None]
    x = theads.stacked_frames(emb, t, 14, 14, c)
    frames = emb.reshape(t, 14, 14, c)
    for k in range(c * t):
        assert torch.equal(x[0, k], frames[k % t, :, :, k // t])


def test_conv_policy_head_matches_jax():
    c, h, w = 8, 14, 14
    jm = jheads.ConvPolicyHead(embedding_dim=(c, h, w), proprio_dim=5, history_window=2, action_dim=4)
    tm = theads.ConvPolicyHead(embedding_dim=(c, h, w), proprio_dim=5, history_window=2, action_dim=4)
    obs = np.random.RandomState(2).randn(3, 2 * h * w * c + 5).astype(np.float32)
    jparams = _head_pair(jm, tm, obs, 2)
    _check_forward_and_grads(jm, jparams, tm, obs)


def test_trifinger_policy_matches_jax():
    kw = dict(type="ConvBatchNormMLP", task_state_type="ftpos", train_ft_state_shape=9, pretrained_dim=(16, 14, 14),
              task_goal_type="goal_cond", out_dim=9, max_a=0.1, hidden_size=32)
    jm, tm = jtrifinger.construct_policy(**kw), ttrifinger.construct_policy(**kw)
    assert tm.in_dim == jm.in_dim == (32, 14, 14) and tm.extra_dim == jm.extra_dim == 9
    state = np.random.RandomState(0).randn(2, 14 * 14 * 32 + 9).astype(np.float32)
    jparams = _head_pair(jm, tm, state, 4)
    _check_forward_and_grads(jm, jparams, tm, state)
    out = tm(torch.from_numpy(state) * 50)
    clipped = tm.clip_action(out)
    np.testing.assert_allclose(clipped.detach().numpy(), np.asarray(jm.clip_action(jnp.asarray(out.detach().numpy()))))
    assert bool(clipped.abs().max() <= torch.tensor(0.1)) and torch.equal(tm.scale_to_range(out), out)


@pytest.mark.parametrize("kw", [
    dict(task_state_type="bogus"),
    dict(task_goal_type="bogus"),
    dict(type="Transformer"),
    dict(task_state_type="obj", task_goal_type="goal_o_pos"),
    dict(task_state_type="ftpos_obj", task_goal_type="goal_none"),
])
def test_construct_policy_cases_match_jax(kw):
    args = dict(type="ConvBatchNormMLP", task_state_type="ftpos", train_ft_state_shape=9,
                pretrained_dim=(4, 14, 14), task_goal_type="goal_none", out_dim=2, max_a=None)
    args.update(kw)
    outcomes = []
    for package in (jtrifinger, ttrifinger):
        try:
            p = package.construct_policy(**args)
            outcomes.append((tuple(p.in_dim), p.extra_dim, p.out_dim, p.max_a))
        except (NameError, NotImplementedError) as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]


# --------------------------------------------------------------- VFM encoders


def _uint8(n, side, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def test_vfm_encoder_dinov2_and_clip_match_jax(monkeypatch):
    cfg = jtowers.TowerConfig(**SMALL)
    monkeypatch.setattr(jdinov2, "DINOV2_LARGE", cfg)
    monkeypatch.setattr(tdinov2, "DINOV2_LARGE", cfg)
    monkeypatch.setattr(jclip, "CLIP_VIT_LARGE", cfg)
    monkeypatch.setattr(tclip, "CLIP_VIT_LARGE", cfg)
    for name, conv, side, method in (("facebook/dinov2-large", convert.dinov2_state_dict, 224, None),
                                     ("facebook/dinov2-large", convert.dinov2_state_dict, 224, "mean_pooling"),
                                     ("openai/clip-vit-large-patch14", convert.clip_vision_state_dict, 224, None)):
        jenc = jvfm.VFMEncoder(name, method)
        params = _perturb(jax.jit(jenc.module.init)(jax.random.PRNGKey(1), jnp.zeros((1, side, side, 3), jnp.uint8))
                          ["params"], 1)
        jenc.load_params(params)
        if method is None:
            tenc = tvfm.VFMEncoder(name, method, state_dict=conv(params), device="cpu")
        else:  # a seeded init, then the weights loaded (the JAX load_params)
            tenc = tvfm.VFMEncoder(name, method, device="cpu", generator=torch.Generator().manual_seed(0))
            tenc.load_state_dict(conv(params))
        imgs = _uint8(2, side, 5)
        got, want = tenc.forward_feature(imgs), np.asarray(jax.jit(jenc.forward_feature)(jnp.asarray(imgs)))
        assert got.shape == want.shape == ((2, 196, 64) if method is None else (2, 64))
        _close(got, want)


def test_concat_vfm_encoder_truncates_to_the_fewest_tokens(monkeypatch):
    """DINOv2 (196 spatial tokens at 224 px, patches of 16) with a DeiT of
    patches of 14 (256): the concat keeps 196 tokens of each, as the JAX
    one does. Both processors keep 224 px as it is."""
    cfg = jtowers.TowerConfig(**SMALL)
    monkeypatch.setattr(jdinov2, "DINOV2_LARGE", cfg)
    monkeypatch.setattr(tdinov2, "DINOV2_LARGE", cfg)
    deit = "facebook/deit-tiny-patch16-224"
    for table in (jfvit.DEIT_TEACHERS, tfvit.DEIT_TEACHERS):
        monkeypatch.setitem(table, deit, dataclasses.replace(table[deit], num_layers=1, patch_size=14,
                                                             resize_size=224))
    names = ["facebook/dinov2-large", deit]
    jenc = jvfm.ConcatVFMEncoder(names)
    dparams = _perturb(jax.jit(jenc.encoders[0].module.init)(jax.random.PRNGKey(2),
                                                             jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"], 2)
    vparams = _perturb(jax.jit(jenc.encoders[1].module.init)(jax.random.PRNGKey(3),
                                                             jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"], 3)
    jenc.encoders[0].load_params(dparams)
    jenc.encoders[1].load_params(vparams)
    tenc = tvfm.ConcatVFMEncoder(names, state_dicts={names[0]: convert.dinov2_state_dict(dparams),
                                                     names[1]: convert.vit_teacher_state_dict(vparams)}, device="cpu")
    imgs = _uint8(2, 224, 6)
    got, want = tenc(imgs), np.asarray(jax.jit(jenc.forward)(jnp.asarray(imgs)))
    assert got.shape == want.shape == (2, 196, 64 + 192)
    _close(got, want)


def test_vfm_encoder_sam_flattens_its_map(monkeypatch):
    cfg = jsam.SamVisionConfig(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64, image_size=128, patch_size=16,
                               window_size=4, global_attn_indexes=(1,), output_channels=8)
    jmod = jsam.SamVisionEncoder(cfg)
    params = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(4), jnp.zeros((1, 128, 128, 3), jnp.uint8))["params"], 4)
    tower = tsam.get_sam_model(state_dict=convert.sam_vision_state_dict(params), device="cpu",
                               cfg=tsam.SamVisionConfig(**dataclasses.asdict(cfg)))
    monkeypatch.setattr(jsam, "SAM_VIT_HUGE", cfg)
    jenc = jvfm.VFMEncoder.__new__(jvfm.VFMEncoder)
    jenc.model_name, jenc.feature_reduce_method, jenc.module, jenc.params = "facebook/sam-vit-huge", None, jmod, params
    tenc = tvfm.VFMEncoder.__new__(tvfm.VFMEncoder)
    tenc.model_name, tenc.feature_reduce_method, tenc.module = "facebook/sam-vit-huge", None, tower
    tenc.device = torch.device("cpu")
    imgs = _uint8(2, 128, 7)
    got, want = tenc.forward_feature(imgs), np.asarray(jax.jit(jenc.forward_feature)(jnp.asarray(imgs)))
    assert got.shape == want.shape == (2, 64, 8)
    _close(got, want)


@pytest.mark.parametrize("name", ["mvp-vitb-mae-egosoup", "vip", "r3m-resnet50", "bogus/model"])
def test_baselines_raise_as_the_jax_package_does(name):
    raised = []
    for package in (jvfm, tvfm):
        with pytest.raises(Exception) as err:
            package.VFMEncoder(name) if package is jvfm else package.VFMEncoder(name, device="cpu")
        raised.append(type(err.value))
    assert raised[0] is raised[1]
    if name.startswith(("mvp", "vip", "r3m")):
        assert issubclass(raised[0], ImportError)


@pytest.mark.gpu
def test_policy_heads_backward_launches_k3_and_k4_on_the_card():
    """One backward of each head on the card: K3 and K4 once a
    LayerNormSpatial (3 + 3 and 2 + 2), gradients against the same heads'
    plain backward (``LN_STATS_IMPL="vpu"``) within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theia_tpu_torch.models import layers
    from theia_tpu_torch.ops import ln_pallas

    for cls, n_ln, kw in ((theads.ConvBatchNormMLP, 3, dict(proprio_dim=9, history_window=3)),
                          (theads.ConvPolicyHead, 2, dict(proprio_dim=0, history_window=1))):
        head = cls(embedding_dim=(768, 14, 14), action_dim=7, **kw).cuda()
        obs = torch.randn(32, kw["history_window"] * 14 * 14 * 768 + kw["proprio_dim"], device="cuda")
        grads = []
        for impl in ("pallas", "vpu"):
            layers.LN_STATS_IMPL = impl
            before = (ln_pallas.LN_BWD_STATS_LAUNCHES, ln_pallas.LN_BWD_DX_LAUNCHES)
            head.zero_grad()
            head(obs).square().sum().backward()
            grads.append({n: p.grad.clone() for n, p in head.named_parameters() if p.grad is not None})
            launched = (ln_pallas.LN_BWD_STATS_LAUNCHES - before[0], ln_pallas.LN_BWD_DX_LAUNCHES - before[1])
            assert launched == ((n_ln, n_ln) if impl == "pallas" else (0, 0))
        layers.LN_STATS_IMPL = "pallas"
        for n, g in grads[1].items():
            torch.testing.assert_close(grads[0][n], g, atol=1e-3, rtol=1e-3)
