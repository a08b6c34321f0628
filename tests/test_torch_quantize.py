"""Int8 weight quantization in the port (``models/quantize.py``) against the JAX
package's ``models/quantize.py``, on the tiny SD1.5-like UNet of
``test_torch_unet.py`` (the same numpy weights on both sides, the port's through
``convert_jax``), with ``min_size`` lowered to 256 so the tiny weights quantize.

The rule is the same on both sides: per output channel, ``scale = max(|w|,
1e-12) / 127``, ``q = clip(round(w / scale), -127, 127)``. The port reduces over
every axis but a torch weight's axis 0 (its output channel); flax puts that
channel last. The JAX attention q/k/v kernels are ``DenseGeneral`` (C, H, D), whose
last-axis rule shares one scale per head-dim index over the heads; the port's
(H·D, C) weights carry ``int8_row_groups`` = H and share it the same way. So after
``convert_jax`` every int8 payload, scale and dequantized weight equals the JAX
one exactly, and the quantized forwards agree at the f32 parity tolerance
(rtol/atol 2e-4).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_unet import _inputs, _pair, _port  # noqa: E402

from comfyui_parallelanything_tpu.models import quantize as jq  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import mmdit as pmmdit  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import quantize as pq  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_mmdit_params,
    from_jax_params,
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

MIN_SIZE = 256
_JAX_QUANTIZE_PARAMS = jq.quantize_params  # before any test patches it
TOL = dict(rtol=2e-4, atol=2e-4)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _quantized_port(tree):
    jm, pm, _ = _pair("sd15_like")
    model = pu.build_unet(pm.config, device="cpu", state_dict=from_jax_unet_params(tree))
    return pq.quantize_model(model, min_size=MIN_SIZE)


def _payloads(module):
    """{weight name: (int8 payload, f32 scales, the scales broadcast to the weight's
    shape, dequantized weight)} of a quantized module, named as its unquantized state
    dict names them."""
    out = {}
    for name, mod in module.named_modules():
        if hasattr(mod, "parametrizations"):
            for attr, plist in mod.parametrizations.items():
                q, deq = plist.original, plist[0]
                per_entry = (torch.ones(q.shape).unflatten(0, (deq.groups, -1))
                             * deq.scale).reshape(q.shape)
                key = f"{name}.{attr}" if name else attr
                out[key] = (q, deq.scale, per_entry, getattr(mod, attr))
    return out


@functools.cache
def _jax_quantized():
    """The JAX package's int8 tree of the whole UNet, with the bits of the eager run
    that its ``quantize_model`` makes. Eager, each leaf shape's ops compile apart (9 s
    here), so it runs as one program instead, with XLA's algebraic simplifier off:
    that pass alone changes the bits, by turning the division by 127 into a multiply
    (a last-bit difference in some scales)."""
    _, _, tree = _pair("sd15_like")
    program = jax.jit(lambda p: _JAX_QUANTIZE_PARAMS(p, min_size=MIN_SIZE)).lower(tree)
    return program.compile(compiler_options={"xla_disable_hlo_passes": "algsimp"})(tree)


def _as_port(qtree, fn):
    """A QuantTensor tree's ``fn(leaf)`` in the port's names and layouts (``convert_jax``);
    unquantized leaves map to empty tensors."""
    return from_jax_unet_params(jax.tree.map(
        lambda l: np.asarray(fn(l)) if isinstance(l, jq.QuantTensor) else np.zeros(0),
        qtree, is_leaf=lambda l: isinstance(l, jq.QuantTensor)))


QKV = {f"attn{i}_{p}" for i in (1, 2) for p in "qkv"}


def test_payload_scales_and_weights_match_jax_after_convert_jax():
    jm, pm, tree = _pair("sd15_like")
    got = _payloads(_quantized_port(tree).module)
    qtree = _jax_quantized()
    want_q = _as_port(qtree, lambda l: l.q)
    # A scale keeps its kernel's rank (size 1 off the channel axis): broadcast it to
    # the kernel's shape so convert_jax lays it out like the weight.
    want_s = _as_port(qtree, lambda l: np.broadcast_to(l.scale, l.q.shape))
    n_scales = _as_port(qtree, lambda l: np.asarray(l.scale).reshape(-1))
    names = {k for k, v in want_q.items() if v.numel()}
    assert names == set(got) and len(got) > 20
    # Every kernel layout is among them: Conv, Dense, the transformer's 1x1 proj
    # convs, DenseGeneral q/k/v (C, H, D) and o (H, D, C), the feed-forward.
    assert {n.rsplit(".", 2)[-2] for n in names} >= QKV | {"attn1_o", "ff_in", "proj_in"}
    for name in sorted(names):
        q, scale, per_entry, w = got[name]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        torch.testing.assert_close(q, want_q[name].to(torch.int8), rtol=0, atol=0, msg=name)
        torch.testing.assert_close(per_entry, want_s[name], rtol=0, atol=0, msg=name)
        # QuantTensor.dequantize(f32) is this one f32 product.
        want_w = want_q[name].to(torch.float32) * want_s[name]
        torch.testing.assert_close(w, want_w, rtol=0, atol=0, msg=name)
        assert scale.numel() == n_scales[name].numel(), name  # one stored per JAX scale


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_fused_qkv_scales_match_jax_dense_general(family):
    # FLUX's double-block qkv and the MMDiT's are DenseGeneral (hidden, 3, H, D)
    # kernels in the JAX package: one scale per head-dim index, shared over q, k, v
    # and the heads. The port's fused (3·H·D, hidden) Linear shares it the same way.
    if family == "flux":
        cfg = pflux.FluxConfig(hidden_size=64, num_heads=4, dtype=torch.float32)
        name, convert, block = "img_attn_qkv", from_jax_params, pflux.DoubleBlock(cfg)
    else:
        cfg = pmmdit.MMDiTConfig(depth=2, dtype=torch.float32)  # 2 heads of 64
        name, convert, block = "qkv", from_jax_mmdit_params, pmmdit._StreamAttnIn(cfg)
    kernel = np.random.default_rng(5).normal(
        size=(cfg.hidden_size, 3, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    jt = _JAX_QUANTIZE_PARAMS({name: {"kernel": kernel}}, min_size=MIN_SIZE)[name]["kernel"]
    key = f"{name}.weight"
    lin = getattr(block, name)
    with torch.no_grad():
        lin.weight.copy_(convert({name: {"kernel": kernel}})[key])
    q, scale, per_entry, w = _payloads(pq.quantize_module(lin, MIN_SIZE))["weight"]
    want_q = convert({name: {"kernel": np.asarray(jt.q)}})[key]
    want_s = convert({name: {"kernel": np.broadcast_to(jt.scale, jt.q.shape)}})[key]
    torch.testing.assert_close(q, want_q, rtol=0, atol=0)
    torch.testing.assert_close(per_entry, want_s, rtol=0, atol=0)
    torch.testing.assert_close(w, want_q.to(torch.float32) * want_s, rtol=0, atol=0)
    assert scale.numel() == np.asarray(jt.scale).size == cfg.head_dim


def test_quantized_forward_within_limit_of_jax_quantize_model(monkeypatch):
    jm, pm, tree = _pair("sd15_like")
    monkeypatch.setattr(jq, "quantize_params", lambda params, min_size: _jax_quantized())
    jqm = jq.quantize_model(jm, min_size=MIN_SIZE, dtype=jnp.float32)
    x, t, ctx, kw = _inputs(1, jm.config)
    want = np.asarray(jqm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = _port(_quantized_port(tree), x, t, ctx, kw)
    torch.testing.assert_close(got, torch.from_numpy(want.copy()), **TOL)
    full = _port(pm, x, t, ctx, kw).numpy()
    assert _rel_l2(full, want) > 100 * _rel_l2(got, want)  # the check sees quantization


def test_only_int8_and_scales_stay_resident():
    jm, pm, tree = _pair("sd15_like")
    before = pq.param_bytes(pm.module)
    model = _quantized_port(tree)
    after = pq.param_bytes(model.module)
    assert after < 0.4 * before  # f32 → int8 for nearly every weight
    # The dequantized weights are made in the forward, not kept.
    assert all(p.dtype in (torch.int8, torch.float32) for p in model.module.parameters())
    assert not any(p.dtype == torch.float32 and p.ndim == 4 and p.numel() >= MIN_SIZE
                   for p in model.module.parameters())


def test_every_consumer_takes_the_quantized_model_unchanged():
    jm, pm, tree = _pair("sd15_like")
    model = _quantized_port(tree)
    x, t, ctx, kw = _inputs(1, jm.config, batch=2)
    T = torch.from_numpy
    want = _port(model, x, t, ctx, kw)
    # Data parallel over two replicas (each a copy holding int8 and scales).
    dp = parallelize(model, [("cpu:0", 50), ("cpu:1", 50)], ParallelConfig(
        auto_memory_balance=False))
    torch.testing.assert_close(dp(T(x), T(t), T(ctx)), want, rtol=1e-5, atol=1e-5)
    assert all(p.dtype in (torch.int8, torch.float32) for r in dp._replicas
               for p in r.parameters())
    # Batch 1: the pipeline stages are views over the same quantized submodules.
    one = _port(model, x[:1], t[:1], ctx[:1], kw)
    torch.testing.assert_close(dp(T(x[:1]), T(t[:1]), T(ctx[:1])), one, rtol=1e-5, atol=1e-5)
    assert dp._pipeline_runner is not None and dp._pipeline_runner.n_stages == 2
    # The whole-loop sampler (on CPU tensors its body runs uncaptured).
    noise = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    kws = dict(sampler="euler", steps=2, cfg_scale=3.0, uncond_context=T(ctx[1:]))
    eager = run_sampler(model, noise, T(ctx[:1]), **kws)
    looped = run_sampler(model, noise, T(ctx[:1]), compile_loop=True, **kws)
    torch.testing.assert_close(looped, eager, rtol=1e-5, atol=1e-5)


def test_eligibility_rule_matches_jax():
    for shape in [(256,), (16, 16), (15, 17), (4, 4, 4, 4), (2, 2, 2, 32), (65536,)]:
        assert pq.int8_eligible(shape, MIN_SIZE) == jq.int8_eligible(shape, MIN_SIZE)
    assert pq.int8_eligible((320, 320, 3, 3)) and not pq.int8_eligible((320, 4, 3, 3))
    w = torch.zeros(4, 300)
    q, scale = pq.quantize_tensor(w)
    assert torch.equal(q, torch.zeros_like(q)) and torch.all(scale == 1e-12 / 127.0)
