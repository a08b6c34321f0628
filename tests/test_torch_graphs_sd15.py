"""The shipped SD1.5 example graphs end to end through both graph hosts: the port's
``host.run_workflow`` (on the CPU) and the JAX package's, on the same tiny random
weights and the same injected noise, compared node output by node output.

The synthetic world (``graph_env``): the port's tiny SD1.5 UNet, VAE and CLIP-L
made from seeded generators and written to a tmp dir in their public layouts
(``chip_smoke.write_sd15_files``: ldm checkpoint with the bundled VAE, HF CLIP
tower, each held by a round trip through the port's converters, with
the port's ``models.loader.save_safetensors``), and the CLIP byte-BPE tables of
``chip_smoke.write_clip_tables``. Both packages' preset factories are patched to
the matching tiny configs. Each graph is rewritten only where a user would edit
it: file paths, the devices (``cpu:0`` + ``cpu:1``), the steps (2) and the image
size; the port also runs ``TPUSaveImage`` / ``TPULoadImage``.

Noise: both sides draw the same numpy noise for a shape (``shape_noise``): the JAX
side through a patched ``jax.random.normal`` (the KSampler's draw at
``nodes.py:1525`` and the VAE's posterior draw), the port through its
``nodes.initial_noise`` and ``vae.posterior_noise``. The samplers are
non-ancestral. JAX compiles each program once per shape and model object, so the
graphs of a file share one ``WorkflowCache`` per host (the loaders run once) and
the same latent sizes. Every JAX run points ``PA_LEDGER_DIR`` and
``PA_EVIDENCE_DIR`` at the test's tmp dir.

This file: ``workflow_sd15_txt2img`` and ``workflow_custom_sampling``, and the
helpers the other ``test_torch_graphs_*.py`` files share.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import comfyui_parallelanything_tpu.models as jmodels  # noqa: E402
import comfyui_parallelanything_tpu.models.text_encoders as jte  # noqa: E402
import comfyui_parallelanything_tpu_torch.models as pmodels  # noqa: E402
import comfyui_parallelanything_tpu_torch.models.text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu import host as jhost  # noqa: E402
from comfyui_parallelanything_tpu_torch import host as phost  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pnodes  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vae as pvae  # noqa: E402

# f32 on both sides; two sampler steps at CFG 7-7.5 carry the forwards' f32
# differences into the latent a little amplified, so latents and images are held at
# 1e-3 (relative to their scale) and every node's own parity at 2e-4 in
# test_torch_nodes.py.
TOL = dict(rtol=1e-3, atol=1e-3)
UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            transformer_depth=(1, 0), attention_levels=(0,), num_heads=4, norm_groups=8)
VAE = dict(z_channels=4, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
           norm_groups=8)
# CLIP-L's shape at a tiny width: the synthetic vocab's BOS/EOS ids are CLIP-L's
# (49406/49407), so the table keeps 49408 rows.
CLIP = dict(vocab_size=49408, hidden_size=48, num_layers=2, num_heads=4, max_len=16,
            eos_id=49407)
LATENT_HW = 32  # pixels the graph asks for; the tiny VAE's factor is 2


def shape_noise(shape) -> np.ndarray:
    """The N(0, 1) draw both hosts get for a shape."""
    seed = int(np.prod(shape)) * 7 + len(shape)
    return np.random.default_rng(seed).standard_normal(tuple(int(s) for s in shape)).astype(
        np.float32)


def _jax_configs():
    jcfg = jmodels.sd15_config(**UNET, context_dim=CLIP["hidden_size"], dtype=jnp.float32)
    jvae = jmodels.VAEConfig(**VAE, dtype=jnp.float32)
    jclip = jte.CLIPTextConfig(**CLIP, dtype=jnp.float32)
    return jcfg, jvae, jclip


def _port_configs():
    pcfg = pmodels.sd15_config(**UNET, context_dim=CLIP["hidden_size"], dtype=torch.float32)
    pv = pmodels.VAEConfig(**VAE, dtype=torch.float32)
    pclip = pte.CLIPTextConfig(**CLIP, dtype=torch.float32)
    return pcfg, pv, pclip


def build_graph_env(tmp_dir, monkeypatch) -> dict:
    """The synthetic files under ``tmp_dir``, both packages patched (through
    ``monkeypatch``) to the tiny configs and to the shared noise, and the JAX ledger
    redirected into ``tmp_dir``. Returns a dict of paths."""
    monkeypatch.setenv("PA_LEDGER_DIR", os.path.join(tmp_dir, "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", os.path.join(tmp_dir, "evidence"))
    jcfg, jvae, jclip = _jax_configs()
    pcfg, pv, pclip = _port_configs()
    monkeypatch.setattr(jmodels, "sd15_config", lambda: jcfg)
    monkeypatch.setattr(jmodels, "sd_vae_config", lambda: jvae)
    monkeypatch.setattr(jte, "clip_l_config", lambda: jclip)
    monkeypatch.setattr(pmodels, "sd15_config", lambda: pcfg)
    monkeypatch.setattr(pmodels, "sd_vae_config", lambda: pv)
    monkeypatch.setattr(pte, "clip_l_config", lambda: pclip)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(shape_noise(shape), dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(pnodes, "initial_noise",
                        lambda seed, shape, device: torch.from_numpy(shape_noise(shape)))
    monkeypatch.setattr(pvae, "posterior_noise",
                        lambda shape, dtype, device, gen: torch.from_numpy(shape_noise(shape)))

    gen = torch.Generator().manual_seed(0)
    unet = pmodels.build_unet(pcfg, device="cpu", generator=gen)
    vae = pmodels.build_vae(pv, device="cpu", generator=gen)
    clip = pmodels.build_clip_text(pclip, device="cpu", generator=gen)
    with torch.no_grad():
        # Off the default init (zero biases, unit norm scales), so every tensor counts.
        for m in (unet.module, vae.module, clip.module):
            for name, p in m.named_parameters():
                if name.endswith("bias") or p.ndim == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
    paths = chip_smoke.write_sd15_files(tmp_dir, unet, vae, clip)
    paths["vocab"], paths["merges"] = chip_smoke.write_clip_tables(tmp_dir)
    paths["tmp"] = tmp_dir
    return paths


@pytest.fixture
def graph_env(tmp_path, monkeypatch):
    return build_graph_env(str(tmp_path), monkeypatch)


def load_example(name: str, paths: dict) -> dict:
    """An example graph with what a user edits rewritten: file paths, the two devices
    (``cpu:0`` + ``cpu:1``), 2 sampler steps, the latent size, and the save node's
    directory."""
    with open(os.path.join("examples", f"{name}.json")) as f:
        wf = json.load(f)
    wf["checkpoint"]["inputs"]["ckpt_path"] = paths["ckpt"]
    clip = wf["clip"]["inputs"]
    clip.pop("tokenizer_json", None)
    clip.update(encoder_path=paths["clip"], vocab_path=paths["vocab"],
                merges_path=paths["merges"], max_len=CLIP["max_len"])
    wf["dev0"]["inputs"]["device_id"] = "cpu:0"
    wf["dev1"]["inputs"]["device_id"] = "cpu:1"
    for node in wf.values():
        ins = node["inputs"]
        if "steps" in ins:
            ins["steps"] = 2
        if node["class_type"] == "TPUEmptyLatent":
            ins.update(width=LATENT_HW, height=LATENT_HW, batch_size=min(ins["batch_size"], 2))
        if node["class_type"] == "TPUSaveImage":
            ins["output_dir"] = os.path.join(paths["tmp"], "out")
    return wf


def run_both(wf: dict, port_cache=None, jax_cache=None) -> tuple[dict, dict]:
    """The graph through the port's host on the CPU and through the JAX host."""
    got = phost.run_workflow(wf, outputs=port_cache, device="cpu")
    jax_wf = {k: v for k, v in wf.items() if v["class_type"] != "TPUSaveImage"}
    want = jhost.run_workflow(jax_wf, outputs=jax_cache)
    return got, want


def assert_close(got, want, what: str, tol=TOL):
    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g / scale, w / scale, err_msg=what, **tol)


def assert_saved(got: dict, n: int):
    saved = got["save"][0]
    assert len(saved) == n and all(os.path.exists(p) for p in saved)


def test_txt2img_and_custom_sampling_match_jax(graph_env, cpu_devices):
    pcache, jcache = phost.WorkflowCache(), jhost.WorkflowCache()
    wf = load_example("workflow_sd15_txt2img", graph_env)
    got, want = run_both(wf, pcache, jcache)
    assert got["parallel"][0].devices == ("cpu:0", "cpu:1")
    assert_close(got["positive"][0]["context"], want["positive"][0]["context"], "context",
                 dict(rtol=2e-4, atol=2e-4))
    assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    assert_close(got["decode"][0], want["decode"][0], "image")
    assert got["decode"][0].shape == (2, LATENT_HW // 4, LATENT_HW // 4, 3)
    assert_saved(got, 2)

    # The custom-sampling graph shares the loaders, prompts and latent: both caches
    # serve them, and only the sampling nodes run.
    ran = []
    wf = load_example("workflow_custom_sampling", graph_env)
    got = phost.run_workflow(wf, outputs=pcache, device="cpu", on_node=ran.append)
    want = jhost.run_workflow({k: v for k, v in wf.items()
                               if v["class_type"] != "TPUSaveImage"}, outputs=jcache)
    assert "checkpoint" not in ran and "sampler" in ran
    assert_close(got["sigmas"][0], want["sigmas"][0], "sigmas", dict(rtol=1e-6, atol=1e-6))
    assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    assert_close(got["decode"][0], want["decode"][0], "image")
    assert_saved(got, 2)
