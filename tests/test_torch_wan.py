"""Parity of the PyTorch port's Wan video DiT (``models/wan.py``), its converters
and loader, the i2v composition and the Wan2.2 expert switch against the JAX
package on the CPU, at the JAX tests' tiny size (hidden 48, 4 heads, depth 2,
text_dim 32, f32).

Weights are numpy draws for the JAX models' abstract parameter trees (no flax init
is run); the port takes them through ``convert_jax.from_jax_wan_params`` or, for the
converter cases, through the public Wan2.x layout that
``tests/test_convert_wan._official_layout_sd`` writes from the same tree. Both sides
run in f32 (the JAX side under the suite's ``highest`` matmul precision, each
program jitted once per shape) and must agree to rtol/atol 2e-4.
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import experts as jexperts  # noqa: E402
from comfyui_parallelanything_tpu.models import loader as jload  # noqa: E402
from comfyui_parallelanything_tpu.models import wan as jwan  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import experts as pexperts  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as pload  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import wan as pwan  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_wan_params,
)
from comfyui_parallelanything_tpu_torch.models.convert_wan import (  # noqa: E402
    convert_wan_checkpoint,
)
from comfyui_parallelanything_tpu_torch.utils.logging import get_logger  # noqa: E402

from test_convert_wan import _official_layout_sd  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(out_channels=4, hidden_size=48, ffn_dim=96, num_heads=4, depth=2, text_dim=32,
            freq_dim=32)
VARIANTS = {"t2v": dict(in_channels=4), "i2v_clip": dict(in_channels=12, img_dim=24)}
X_SHAPE = (2, 2, 8, 8, 4)  # (B, T, H, W, C): 2 frames of 4 × 4 patches
TXT, IMG_TOKENS = 8, 5


def _numpy_tree(abstract, seed):
    """Random weights for an abstract flax tree: kernels N(0, 1/fan_in), every
    other leaf off its init value (scales about 1, biases and modulations about 0)
    so its conversion is checked too."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _inputs(variant, seed=0):
    rng = np.random.default_rng(seed)
    cfg = VARIANTS[variant]
    x = rng.normal(size=X_SHAPE[:-1] + (cfg["in_channels"],)).astype(np.float32)
    t = np.array([0.9, 0.3], np.float32)
    ctx = rng.normal(size=(2, TXT, 32)).astype(np.float32)
    kw = {}
    if "img_dim" in cfg:
        kw["clip_fea"] = rng.normal(size=(2, IMG_TOKENS, cfg["img_dim"])).astype(np.float32)
    return x, t, ctx, kw


def _jnp(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _pt(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def pairs():
    """Per variant: the JAX model, the numpy tree, the port model, and the JAX
    forward on ``_inputs`` (computed once)."""
    out = {}
    for i, (variant, extra) in enumerate(VARIANTS.items()):
        jcfg = jwan.WanConfig(**TINY, **extra, dtype=jnp.float32)
        x, t, ctx, kw = _inputs(variant)
        module = jwan.WanModel(jcfg)
        abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx), **_jnp(kw))["params"]
        tree = _numpy_tree(abstract, 10 + i)
        jm = jwan.build_wan(jcfg, params=jax.tree.map(jnp.asarray, tree))
        pcfg = pwan.WanConfig(**TINY, **extra, dtype=torch.float32)
        pm = pwan.build_wan(pcfg, device="cpu", state_dict=from_jax_wan_params(tree))
        # The jitted forward becomes the model's apply, so a composition around it
        # (apply_i2v_conditioning) reuses its compiled program.
        jm = dataclasses.replace(jm, apply=jax.jit(jm.apply))
        want = np.asarray(jm.apply(jm.params, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(ctx), **_jnp(kw)))
        out[variant] = (jm, tree, pm, want)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(pairs, variant):
    _, _, pm, want = pairs[variant]
    x, t, ctx, kw = _inputs(variant)
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), **_pt(kw))
    assert got.shape == X_SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_axes_dim_and_configs_match_jax():
    for name in ("wan_1_3b_config", "wan_14b_config", "wan_14b_i2v_config",
                 "wan_14b_i2v_clip_config"):
        j, p = getattr(jwan, name)(), getattr(pwan, name)()
        for field in ("in_channels", "hidden_size", "ffn_dim", "num_heads", "depth",
                      "text_dim", "freq_dim", "patch_size", "img_dim", "prediction"):
            assert getattr(p, field) == getattr(j, field), (name, field)
        assert p.axes_dim == j.axes_dim and sum(p.axes_dim) == p.head_dim
        assert p.dtype == torch.bfloat16


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stages_match_the_jax_pipeline_spec(pairs, variant):
    jm, _, pm, want = pairs[variant]
    js, ps = jm.pipeline_spec, pm.pipeline_spec
    assert ps.prepare_keys == js.prepare_keys
    assert ps.finalize_keys == js.finalize_keys
    assert [s.param_keys for s in ps.segments] == [
        tuple(k.replace("_", ".", 1) if k.startswith("blocks_") else k for k in s.param_keys)
        for s in js.segments]
    assert [s.label for s in ps.segments] == [s.label for s in js.segments]
    x, t, ctx, kw = _inputs(variant)

    def staged(p, x, t, ctx, kw):  # the JAX spec end to end, one jit program
        carry = js.prepare(p, x, t, ctx, **kw)
        first, xs = carry, []
        for seg in js.segments:
            carry = seg.fn(p, carry)
            xs.append(carry["x"])
        return first, xs, js.finalize(p, carry, X_SHAPE)

    jfirst, jxs, jfinal = jax.jit(staged)(jm.params, jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(ctx), _jnp(kw))
    with torch.no_grad():
        pc = ps.prepare(pm.module, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), **_pt(kw))
        assert set(pc) == set(jfirst)
        for key in jfirst:
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(jfirst[key]), **TOL,
                                       err_msg=key)
        for seg, jx in zip(ps.segments, jxs):
            pc = seg.fn(pm.module, pc)
            np.testing.assert_allclose(pc["x"].numpy(), np.asarray(jx), **TOL)
        got = ps.finalize(pm.module, pc, X_SHAPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfinal), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def port_log():
    handler = _Records()
    get_logger().addHandler(handler)
    yield handler.messages
    get_logger().removeHandler(handler)


def test_i2v_conditioning_matches_jax(pairs, port_log):
    jm, _, pm, _ = pairs["i2v_clip"]
    rng = np.random.default_rng(5)
    x, t, ctx, _ = _inputs("t2v", seed=6)  # the 4 latent channels
    cond = rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32)  # batch 1: tiled to 2
    fea = rng.normal(size=(1, IMG_TOKENS, 24)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    for c, f in ((cond, fea), (None, fea)):  # the concat, and its zero-fill
        jc = jwan.apply_i2v_conditioning(jm, c, f)
        pc = pwan.apply_i2v_conditioning(pm, c, f)
        want = np.asarray(jc.apply(jc.params, *jargs))
        np.testing.assert_allclose(pc(*args).numpy(), want, **TOL)
    assert pc.name == "wan+i2v" and pc.config is pm.config
    with pytest.raises(ValueError, match="carries 5 channels"):
        pwan.apply_i2v_conditioning(pm, cond[..., :5])
    with pytest.raises(ValueError, match="does not divide"):
        pwan.apply_i2v_conditioning(pm, np.concatenate([cond] * 3))(*args)
    # A t2v checkpoint ignores the tag; an i2v one without the CLIP branch drops
    # clip_fea and keeps the channel concat; both with a warning.
    t2v = pairs["t2v"][2]
    assert pwan.apply_i2v_conditioning(t2v, cond, fea) is t2v
    no_clip = pwan.build_wan(pwan.WanConfig(**TINY, in_channels=12, dtype=torch.float32),
                             device="cpu", generator=torch.Generator().manual_seed(0))
    composed = pwan.apply_i2v_conditioning(no_clip, cond, fea)
    assert composed.module.clip_fea is None and composed.module.cond is not None
    assert composed(*args).shape == X_SHAPE
    assert [("t2v checkpoint" in m, "without the CLIP-vision" in m) for m in port_log] == [
        (True, False), (False, True)]


def test_converter_and_loader_from_the_public_layout(pairs, tmp_path):
    for variant, (jm, tree, pm, want) in pairs.items():
        cfg = pm.config
        sd = _official_layout_sd(jm.config, tree)
        state = convert_wan_checkpoint(sd, cfg)
        ref = from_jax_wan_params(tree)
        assert set(state) == set(ref)
        for k in ref:
            assert torch.equal(state[k], ref[k]), k
        model = pload.load_wan_checkpoint(sd, cfg, device="cpu")
        x, t, ctx, kw = _inputs(variant)
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), **_pt(kw))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # A t2v config reading an i2v file ignores the image branch; a LoRA bakes before
    # conversion as the JAX loader bakes it.
    jm, tree, _, _ = pairs["i2v_clip"]
    t2v_cfg = pwan.WanConfig(**TINY, in_channels=12, dtype=torch.float32)
    assert not any("img" in k for k in convert_wan_checkpoint(
        _official_layout_sd(jm.config, tree), t2v_cfg))
    jm, tree, pm, _ = pairs["t2v"]
    sd = _official_layout_sd(jm.config, tree)
    rng = np.random.default_rng(7)
    lora = {"blocks.0.self_attn.q.lora_A.weight": rng.normal(size=(2, 48)).astype(np.float32),
            "blocks.0.self_attn.q.lora_B.weight": rng.normal(size=(48, 2)).astype(np.float32)}
    got = pload.load_wan_checkpoint(sd, pm.config, lora=lora, lora_strength=0.5, device="cpu")
    jwant = jload.load_wan_checkpoint(sd, jm.config, lora=lora, lora_strength=0.5)
    ref = from_jax_wan_params(jax.tree.map(np.asarray, jwant.params))
    state = got.module.state_dict()
    for k in ref:
        torch.testing.assert_close(state[k], ref[k], rtol=1e-6, atol=1e-6, msg=k)
    delta = 0.5 * lora["blocks.0.self_attn.q.lora_B.weight"] @ lora[
        "blocks.0.self_attn.q.lora_A.weight"]
    np.testing.assert_allclose(state["blocks.0.self_q.weight"].numpy(),
                               sd["blocks.0.self_attn.q.weight"] + delta, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="public Wan2.x layout"):
        pload.load_wan_checkpoint({"patch_embedding.weight": sd["patch_embedding.weight"]},
                                  pm.config, device="cpu")


def _tagged(tag):
    def f(x, t, context=None, **kw):
        return tag

    return f


@pytest.mark.parametrize("t", [0.95, 0.9, 0.875, 0.87, 0.3])
@pytest.mark.parametrize("boundary", ["t2v", "i2v"])
def test_expert_switch_picks_the_jax_expert(t, boundary):
    b = {"t2v": (jexperts.WAN22_T2V_BOUNDARY, pexperts.WAN22_T2V_BOUNDARY),
         "i2v": (jexperts.WAN22_I2V_BOUNDARY, pexperts.WAN22_I2V_BOUNDARY)}[boundary]
    assert b[0] == b[1]
    js = jexperts.TimestepExpertSwitch(_tagged("high"), _tagged("low"), b[0])
    ps = pexperts.TimestepExpertSwitch(_tagged("high"), _tagged("low"), b[1])
    x = np.zeros((2, 1))
    want = js(jnp.asarray(x), jnp.asarray([t, t / 2]))
    assert ps(torch.from_numpy(x), torch.tensor([t, t / 2])) == want
    assert pexperts.TimestepExpertSwitch(1, 2).boundary == jexperts.TimestepExpertSwitch(1, 2).boundary


def test_expert_switch_runs_compile_loop_eagerly(caplog):
    # The expert is picked per step on the host, so a captured loop cannot hold the
    # switch: compile_loop=True logs why and runs the eager loop, as the JAX side does.
    from comfyui_parallelanything_tpu_torch.sampling import runner

    switch = pexperts.TimestepExpertSwitch(_tagged("high"), _tagged("low"))
    with caplog.at_level(logging.INFO, logger=runner.logger.name):
        assert runner._compiled_spec(switch, None) is None
    assert "expert switch" in caplog.text
