"""Parity of the PyTorch port's checkpoint converter (``models/convert.py``) with
the JAX package's on the CPU: ``convert_flux_checkpoint`` from a public-layout
(BFL) FLUX state dict whose block linears are stored as ``float8_e4m3fn``,
``bake_lora`` in the kohya and PEFT conventions, and ``is_float8_dtype``.

The state dict comes from a seeded numpy flax tree through the JAX tests' own
inverse of the converter (``test_convert._torch_layout_sd``); both converters
read the same torch tensors. Forwards agree to f32 rtol/atol 2e-4, baked weights
to 1e-6, converted weights exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import convert as jconv  # noqa: E402
from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert as pconv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_params  # noqa: E402

from test_convert import _torch_layout_sd  # noqa: E402
from test_torch_flux import LATENT, SMALL, TXT, _numpy_params  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
FP8 = torch.float8_e4m3fn


def _is_block_linear(key: str, t) -> bool:
    return key.startswith(("double_blocks.", "single_blocks.")) and key.endswith(".weight") \
        and t.ndim == 2


def public_flux_sd(cfg, seed=21, fp8=True) -> dict:
    """A BFL-layout FLUX state dict of torch tensors: block linears in fp8 (as the
    public fp8 files ship them), everything else in f32."""
    sd = _torch_layout_sd(cfg, _numpy_params(cfg, seed=seed))
    out = {}
    for k, v in sd.items():
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        out[k] = t.to(FP8) if fp8 and _is_block_linear(k, t) else t
    return out


def kohya_lora(sd: dict, rank=2, seed=5, alpha=True, peft=False, keys=None) -> dict:
    """A rank-``rank`` LoRA over ``keys`` (default: every 2-D block weight of
    ``sd``) in the kohya (``lora_unet_…``, down/up/alpha) or PEFT (A/B) names."""
    rng = np.random.default_rng(seed)
    keys = keys or [k for k, v in sd.items() if _is_block_linear(k, v)]
    lora = {}
    for k in keys:
        out_dim, in_dim = sd[k].shape
        base = k[: -len(".weight")]
        down = torch.from_numpy(0.3 * rng.normal(size=(rank, in_dim)).astype(np.float32))
        up = torch.from_numpy(0.3 * rng.normal(size=(out_dim, rank)).astype(np.float32))
        if peft:
            lora[f"{base}.lora_A.weight"], lora[f"{base}.lora_B.weight"] = down, up
        else:
            name = "lora_unet_" + base.replace(".", "_")
            lora[f"{name}.lora_down.weight"], lora[f"{name}.lora_up.weight"] = down, up
            if alpha:
                lora[f"{name}.alpha"] = torch.tensor(float(rank) * 1.5)
    return lora


@functools.cache
def _cfgs():
    return (jflux.flux_dev_config(**SMALL, dtype=jnp.float32),
            pflux.flux_dev_config(**SMALL, dtype=torch.float32))


@functools.cache
def _sd():
    return public_flux_sd(_cfgs()[0])


@functools.cache
def _jax_apply():
    return jax.jit(jflux.FluxModel(_cfgs()[0]).apply)


def _jax_forward(params):
    """The JAX FLUX forward with ``params`` (one jitted program for every caller)."""
    return functools.partial(_jax_apply(), {"params": params})


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, *LATENT)).astype(np.float32), np.array([0.6], np.float32),
            rng.normal(size=(1, TXT, SMALL["context_in_dim"])).astype(np.float32),
            rng.normal(size=(1, SMALL["vec_in_dim"])).astype(np.float32))


def _forwards(lora=None, strength=1.0):
    jcfg, pcfg = _cfgs()
    jparams = jconv.convert_flux_checkpoint(_sd(), jcfg, lora, strength)
    state = pconv.convert_flux_checkpoint(_sd(), pcfg, lora, strength)
    x, t, ctx, y = _inputs()
    want = _jax_forward(jparams)(x, t, ctx, y=y)
    pm = pflux.build_flux(pcfg, device="cpu", state_dict=state, assign=True)
    T = torch.from_numpy
    return np.asarray(want), pm(T(x), T(t), T(ctx), y=T(y)).numpy(), jparams, state


class TestConvertFlux:
    @pytest.mark.parametrize("lora", [False, True], ids=["base", "kohya-lora"])
    def test_fp8_checkpoint_forward_matches_jax(self, lora):
        lora_sd = kohya_lora(_sd()) if lora else None
        want, got, jparams, state = _forwards(lora_sd, 0.5)
        np.testing.assert_allclose(got, want, **TOL)
        # The converted weights are the JAX tree's, carried across exactly.
        carried = from_jax_params(jax.tree.map(np.asarray, jparams))
        assert set(carried) == set(state)
        for k, v in state.items():
            np.testing.assert_allclose(v.numpy(), carried[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)

    def test_bf16_config_takes_each_parameters_dtype_exactly(self):
        jcfg, _ = _cfgs()
        cfg = pflux.flux_dev_config(**SMALL)  # bf16 linears, f32 modulation and final
        state = pconv.convert_flux_checkpoint(_sd(), cfg)
        with torch.device("meta"):
            like = pflux.FluxModel(cfg).state_dict()
        assert {k: v.dtype for k, v in state.items()} == {k: v.dtype for k, v in like.items()}
        q = state["double_blocks.0.img_attn_qkv.weight"]
        assert q.dtype == torch.bfloat16  # fp8 → bf16 is exact
        assert torch.equal(q.float(), _sd()["double_blocks.0.img_attn.qkv.weight"].float())
        assert state["single_blocks.0.modulation.lin.weight"].dtype == torch.float32
        pm = pflux.build_flux(cfg, device="cpu", state_dict=state, assign=True)
        assert pm.module.double_blocks[0].img_attn_qkv.weight.data_ptr() == q.data_ptr()

    def test_wrong_config_raises(self):
        jcfg, pcfg = _cfgs()
        with pytest.raises(KeyError):
            pconv.convert_flux_checkpoint(_sd(), pflux.flux_dev_config(
                **dict(SMALL, depth=2), dtype=torch.float32))
        with pytest.raises(ValueError, match="shape"):
            pconv.convert_flux_checkpoint(_sd(), pflux.flux_dev_config(
                **dict(SMALL, mlp_ratio=4.0), dtype=torch.float32))

    def test_key_map_covers_the_module_and_the_checkpoint(self):
        _, pcfg = _cfgs()
        with torch.device("meta"):
            like = pflux.FluxModel(pcfg).state_dict()
        m = pconv.flux_key_map(pcfg)
        assert set(m) == set(like) and set(m.values()) == set(_sd())


def _bake_pair(sd, lora, strength):
    """(JAX bake, the port's bake materialised) on the same inputs."""
    return jconv.bake_lora(sd, lora, strength), dict(pconv.bake_lora(sd, lora, strength))


class TestBakeLora:
    @pytest.mark.parametrize("alpha,peft,strength", [
        (True, False, 1.0), (False, False, 1.0), (True, False, 0.5), (False, True, 0.5)],
        ids=["kohya-alpha", "kohya-no-alpha", "kohya-strength-0.5", "peft-strength-0.5"])
    def test_matches_jax(self, alpha, peft, strength):
        sd = _sd()
        lora = kohya_lora(sd, alpha=alpha, peft=peft)
        want, got = _bake_pair(sd, lora, strength)
        targets = [k for k, v in sd.items() if _is_block_linear(k, v)]
        assert set(pconv.bake_lora(sd, lora, strength).deltas) == set(targets)
        for k in sd:
            np.testing.assert_allclose(torch.as_tensor(got[k]).float().numpy(), want[k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            if k not in targets:
                assert got[k] is sd[k]  # untouched tensors pass as stored

    def test_stack_matches_jax(self):
        sd = _sd()
        l1, l2 = kohya_lora(sd, seed=1), kohya_lora(sd, seed=2, peft=True)
        want = jconv.bake_lora(jconv.bake_lora(sd, l1, 0.7), l2, 0.4)
        got = pconv.bake_lora(pconv.bake_lora(sd, l1, 0.7), l2, 0.4)
        key = "single_blocks.0.linear1.weight"
        assert len(got.deltas[key]) == 2
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6, atol=1e-6)

    def test_conv_and_unmatched_as_jax(self, caplog):
        rng = np.random.default_rng(3)
        T = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
        sd = {"in.conv.weight": T(6, 4, 3, 3), "out.conv.weight": T(6, 4, 3, 3)}
        lora = {"in.conv.lora_down.weight": T(2, 4, 3, 3), "in.conv.lora_up.weight": T(6, 2, 1, 1),
                "in.conv.alpha": torch.tensor(1.0),
                # a 1×1 LoRA on a 3×3 conv has no place: skipped, as in JAX
                "out.conv.lora_down.weight": T(2, 4, 1, 1), "out.conv.lora_up.weight": T(6, 2, 1, 1),
                "nowhere.lora_down.weight": T(2, 4), "nowhere.lora_up.weight": T(6, 2)}
        want, got = _bake_pair(sd, lora, 1.0)
        for k in sd:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6)
        assert torch.equal(got["out.conv.weight"], sd["out.conv.weight"])
        assert "2 LoRA key(s) had no base match" in caplog.text


@pytest.mark.parametrize("dtype,want", [
    (torch.float8_e4m3fn, True), (torch.float8_e5m2, True), (torch.bfloat16, False),
    (jnp.float8_e4m3fn, True), (jnp.float8_e5m2, True), (np.float16, False),
    ("torch.float8_e4m3fnuz", True), ("float32", False)])
def test_is_float8_dtype_matches_jax(dtype, want):
    name = dtype if isinstance(dtype, str) else (np.dtype(dtype) if not isinstance(
        dtype, torch.dtype) else dtype)
    assert pconv.is_float8_dtype(name) is want
    assert jconv.is_float8_dtype(name) is want


def test_to_tensor_upcasts_numpy_bf16_and_fp8():
    a = np.asarray(jnp.asarray([1.5, -2.25, 0.125], jnp.bfloat16))
    b = np.asarray(jnp.asarray([1.5, -2.25, 0.125], jnp.float8_e4m3fn))
    for arr in (a, b):
        t = pconv.to_tensor(arr, torch.bfloat16)
        assert t.dtype == torch.bfloat16 and t.tolist() == [1.5, -2.25, 0.125]
        np.testing.assert_array_equal(pconv.to_tensor(arr).numpy(), jconv.to_numpy(arr))
