"""Parity of the PyTorch port's per-request LoRA (``models/lora.py``) and
``run_sampler(lora=...)`` with the JAX package's on the CPU.

Factor maps address flax ``kernel`` leaves ``(in, out)`` on the JAX side and torch
weights ``(out, in)`` on the port's, so the port's pair for a JAX pair ``(a, b)``
is ``(b.T, a.T)`` at the carried-across path (``_to_port``). Both sides take the
same numpy weights and factors; merged weights agree to 1e-6, sampled latents to
f32 rtol/atol 2e-4. The tiny FLUX and SD1.5-like UNet are the other parity
files' (``test_torch_flux``, ``test_torch_unet``).

``run_sampler(lora=...)`` runs the port's model through ``parallelize`` on two
``cpu`` links, whose ``lora_model`` merges onto the lead replica and runs the
merged model unsharded. JAX's ``lora_model`` does the same on a chain (it merges
onto the lead's params and rewraps a plain model), which is its ``lora_model`` on
the bare model: the JAX reference runs that, so its forward compiles once per
file instead of once more for the chain's placement.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import lora as jlora  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import run_sampler as jax_run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert as pconv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import lora as plora  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

import test_torch_flux as tf  # noqa: E402
from test_convert import _torch_layout_sd  # noqa: E402
from test_torch_convert import kohya_lora  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
T = torch.from_numpy
# Non-square 2-D targets: a flax kernel and a torch weight cannot be confused there
# (for a square target the JAX extraction takes the torch orientation first).
NON_SQUARE = ("double_blocks.0.img_mod.lin", "double_blocks.0.txt_mod.lin",
              "single_blocks.0.linear1", "single_blocks.0.linear2",
              "single_blocks.0.modulation.lin")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


@functools.cache
def _flux():
    return tf._pair(True)


def _port_path(jax_path: str) -> str:
    """``double_blocks_0/img_mod/lin/kernel`` → ``double_blocks.0.img_mod.lin.weight``."""
    path = re.sub(r"(^|/)(double_blocks|single_blocks)_(\d+)/", r"\1\2.\3/", jax_path)
    path = re.sub(r"(^|/)block_(\d+)/", r"\1blocks.\2/", path)
    return path.replace("/kernel", "/weight").replace("/", ".")


def _to_port(factors):
    return {_port_path(p): (torch.from_numpy(np.asarray(b).T.copy()),
                            torch.from_numpy(np.asarray(a).T.copy()))
            for p, (a, b) in factors.items()}


def _lora_sd(rank=2, seed=5, keys=NON_SQUARE):
    jm, _ = _flux()
    sd = _torch_layout_sd(jm.config, jax.tree.map(np.asarray, jm.params))
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return sd, kohya_lora(sd, rank=rank, seed=seed, keys=[f"{k}.weight" for k in keys])


def _random_factors(params, paths, rank, seed):
    """JAX-side factors for flax leaves: ``a: (r, prod(rest))``, ``b: (shape[0], r)``."""
    rng = np.random.default_rng(seed)
    flat = jlora.flatten_params(params)
    out = {}
    for p in paths:
        w = flat[p]
        k = int(np.prod(w.shape[1:]))
        out[p] = (jnp.asarray(0.2 * rng.normal(size=(rank, k)), jnp.float32),
                  jnp.asarray(0.2 * rng.normal(size=(w.shape[0], rank)), jnp.float32))
    return out


class TestFactors:
    @pytest.mark.parametrize("strength", [1.0, 0.6])
    def test_extract_matches_jax(self, strength):
        jm, pm = _flux()
        _, lora = _lora_sd()
        want = _to_port(jlora.extract_lora_factors(lora, jm.params, strength))
        got = plora.extract_lora_factors(lora, pm.module, strength)
        assert set(got) == set(want) == {f"{k}.weight" for k in NON_SQUARE}
        for p in want:
            for g, w in zip(got[p], want[p]):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)

    def test_aliases_reach_every_block_linear_and_agree_with_the_bake(self):
        # Against the port's parameters a LoRA in checkpoint names also reaches the
        # fused qkv (2-D here, a head-split kernel in flax) and, through the key map,
        # the renamed MLP linears: the merge then equals bake-then-convert.
        _, pm = _flux()
        cfg = pm.config
        sd, _ = _lora_sd()
        lora = kohya_lora(sd, rank=3, seed=9)
        aliases = {v: k for k, v in pconv.flux_key_map(cfg).items()}
        unmatched = []
        factors = plora.extract_lora_factors(lora, pm.module, 0.8, unmatched, aliases=aliases)
        assert unmatched == [] and len(factors) == len(lora) // 3
        merged = plora.lora_model(pm, factors)
        baked = pconv.convert_flux_checkpoint(sd, cfg, lora, 0.8)
        got = merged.module.state_dict()
        for k, v in baked.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert merged.module is not pm.module
        assert pm.module.single_blocks[0].linear1.weight.data_ptr() != \
            merged.module.single_blocks[0].linear1.weight.data_ptr()
        assert pm.module.img_in.weight.data_ptr() == merged.module.img_in.weight.data_ptr()
        assert "mlp_in" not in " ".join(plora.extract_lora_factors(lora, pm.module))

    def test_combine_pad_signature_and_merge_match_jax(self):
        jm, pm = _flux()
        paths = ["single_blocks_0/linear1/kernel", "double_blocks_0/img_attn_qkv/kernel"]
        f1, f2 = (_random_factors(jm.params, paths, r, s) for r, s in ((2, 1), (3, 2)))
        jc = jlora.combine_factors([f1, f2, {}])
        pc = plora.combine_factors([_to_port(f1), _to_port(f2), {}])
        assert plora.combine_factors([]) == {} and set(pc) == set(_to_port(jc))
        for p, (a, b) in _to_port(jc).items():
            assert torch.equal(pc[p][0], a) and torch.equal(pc[p][1], b)
        # The signature flattens a head-split flax kernel (in, 3, H, D) to (in, 3HD):
        # the port's weight is (3HD, in), so its (m, k) is the JAX pair's swapped.
        jsig = jlora.lora_signature(jc, jm.params)
        psig = plora.lora_signature(pc, pm.module)
        assert [(_port_path(p), k, m) for p, m, k in jsig] == sorted(
            [(p, m, k) for p, m, k in psig])
        assert plora.lora_signature({"nope.weight": pc[next(iter(pc))]}, pm.module) is None
        a, b = pc["single_blocks.0.linear1.weight"]
        pa, pb = plora.pad_rank(a, b, 8)
        ja, jb = jlora.pad_rank(jnp.asarray(b.T.numpy()), jnp.asarray(a.T.numpy()), 8)
        assert pa.shape == (8, a.shape[1]) and pb.shape == (b.shape[0], 8)
        assert torch.equal(pb @ pa, b @ a)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(jb).T)
        # merge on a flat dict and on a nested one, against the JAX merge
        jmerged = jlora.flatten_params(jlora.merge_lora_params(jm.params, jc))
        flat = plora.flatten_params(pm.module)
        for params in (flat, {"single_blocks": {"0": {"linear1": {
                "weight": flat["single_blocks.0.linear1.weight"]}}}}):
            sub = {p: f for p, f in pc.items() if p in plora.flatten_params(params)}
            merged = plora.flatten_params(plora.merge_lora_params(params, sub))
            for p in sub:
                jw = np.asarray(jmerged[paths[0] if "linear1" in p else paths[1]])
                np.testing.assert_allclose(merged[p].numpy(), jw.reshape(jw.shape[0], -1).T,
                                           rtol=1e-6, atol=1e-6)
        assert plora.get_path(flat, "img_in.weight") is flat["img_in.weight"]
        with pytest.raises(KeyError):
            plora.get_path({"a": {"b": 1}}, "a.c")

    def test_factorize_bake_matches_jax(self):
        jm, pm = _flux()
        paths = ["single_blocks_0/linear2/kernel"]
        jf = _random_factors(jm.params, paths, 2, 7)
        jbaked = jlora.merge_lora_params(jm.params, jf)
        jrec = jlora.factorize_bake(jm.params, jbaked)
        base = plora.flatten_params(pm.module)
        baked = plora.merge_lora_params(base, _to_port(jf))
        prec = plora.factorize_bake(base, baked)
        assert set(prec) == {_port_path(p) for p in jrec}
        a, b = prec["single_blocks.0.linear2.weight"]
        ja, jb = jrec[paths[0]]
        assert a.shape[0] == ja.shape[0] == 2
        np.testing.assert_allclose((b @ a).numpy(), (np.asarray(jb) @ np.asarray(ja)).T,
                                   rtol=1e-4, atol=1e-6)
        biased = dict(baked, **{"img_in.bias": baked["img_in.bias"] + 1.0})
        assert plora.factorize_bake(base, biased) is None
        assert plora.factorize_bake(base, baked, max_rank=1) is None
        assert plora.factorize_bake(base, {"x": base["img_in.weight"]}) is None
        assert plora.factorize_bake(base, dict(base)) is None

    def test_lora_model_kinds(self):
        _, pm = _flux()
        f = {"img_in.weight": (torch.ones(1, 16), torch.ones(64, 1))}
        assert plora.lora_model(pm, {}) is pm
        merged = plora.lora_model(pm, f)
        assert merged.name == "flux+lora" and merged.pipeline_spec is pm.pipeline_spec
        np.testing.assert_allclose(merged.module.img_in.weight.detach().numpy(),
                                   pm.module.img_in.weight.detach().numpy() + 1.0)
        assert isinstance(plora.lora_model(pm.module, f), pflux.FluxModel)
        with pytest.raises(KeyError):
            plora.lora_model(pm, {"nope.weight": f["img_in.weight"]})
        with pytest.raises(TypeError, match="addressable"):
            plora.lora_model(lambda x, t: x, f)


class TestRunSamplerLora:
    def test_flow_euler_on_flux_matches_jax(self):
        jm, pm = _flux()
        paths = ["single_blocks_0/linear1/kernel", "double_blocks_0/img_attn_proj/kernel",
                 "double_blocks_0/txt_mlp_in/kernel"]
        jf = _random_factors(jm.params, paths, 2, 11)
        x, _, ctx, y = tf._inputs(1, seed=12)
        links = [("cpu:0", 50), ("cpu:1", 50)]
        kw = dict(sampler="flow_euler", steps=2, shift=3.0, guidance=3.5)
        want = jax_run_sampler(jm, jnp.asarray(x), jnp.asarray(ctx), lora=jf, y=jnp.asarray(y),
                               **kw)
        ppm = parallelize(pm, links)
        got = run_sampler(ppm, T(x), T(ctx), lora=_to_port(jf), y=T(y), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        plain = run_sampler(ppm, T(x), T(ctx), y=T(y), **kw)
        assert not np.allclose(plain.numpy(), got.numpy(), **TOL)  # the LoRA mattered

    def test_euler_on_unet_matches_jax(self):
        import test_torch_unet as tu

        jm, pm, _ = tu._pair("sd15_like")
        paths = ["time_embed_0/kernel", "in_0_0_attn/blocks_0/attn1_q/kernel"]
        paths = [p.replace("blocks_0", "block_0") for p in paths]
        jf = _random_factors(jm.params, paths, 2, 13)
        x, _, ctx, _ = tu._inputs(14, jm.config, batch=1)  # the shapes of the other files
        links = [("cpu:0", 50), ("cpu:1", 50)]
        want = jax_run_sampler(jm, jnp.asarray(x), jnp.asarray(ctx), sampler="euler", steps=2,
                               lora=jf)
        got = run_sampler(parallelize(pm, links), T(x), T(ctx), sampler="euler", steps=2,
                          lora=_to_port(jf))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
