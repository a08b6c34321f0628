"""``workflow_stock_sd15_txt2img`` end to end through both graph hosts (the port's on
the CPU, the JAX package's): stock class names only (``CheckpointLoaderSimple`` on a
bare file name under ``$PA_MODELS_DIR/checkpoints``, ``CLIPTextEncode`` on the
checkpoint's bundled CLIP with the tokenizer tables from ``PA_CLIP_VOCAB`` +
``PA_CLIP_MERGES``, ``FreeU_V2``, ``KSampler`` with a seed above 2**63,
``VAEDecode``, ``SaveImage``), on the tiny SD1.5 world of ``test_torch_graphs_sd15``
and its injected noise, compared node output by node output. The graph is edited
only in its size (32², batch 2), steps (2) and seed."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import test_torch_graphs_sd15 as g  # noqa: E402
graph_env = g.graph_env


def stock_models_dir(paths: dict, monkeypatch) -> str:
    """``$PA_MODELS_DIR`` for the stock loaders (``chip_smoke.stock_models_dir``: the
    world's checkpoint with its CLIP-L bundled, as an SD1.5 single file holds it) and
    the tokenizer variables set."""
    root = g.chip_smoke.stock_models_dir(paths, paths["tmp"])
    monkeypatch.setenv("PA_MODELS_DIR", root)
    monkeypatch.setenv("PA_CLIP_VOCAB", paths["vocab"])
    monkeypatch.setenv("PA_CLIP_MERGES", paths["merges"])
    monkeypatch.setenv("PA_OUTPUT_DIR", os.path.join(paths["tmp"], "out"))
    return root


def stock_graph() -> dict:
    with open(os.path.join("examples", "workflow_stock_sd15_txt2img.json")) as f:
        wf = json.load(f)
    wf["5"]["inputs"].update(width=g.LATENT_HW, height=g.LATENT_HW, batch_size=2)
    wf["3"]["inputs"].update(steps=2, seed=2**63 + 7)
    return wf


def test_stock_txt2img_matches_jax(graph_env, monkeypatch, cpu_devices):
    from comfyui_parallelanything_tpu import host as jhost
    from comfyui_parallelanything_tpu_torch import host as phost

    stock_models_dir(graph_env, monkeypatch)
    wf = stock_graph()
    got = phost.run_workflow(wf, device="cpu")
    want = jhost.run_workflow({k: v for k, v in wf.items() if v["class_type"] != "SaveImage"})
    model, patched = got["4"][0], got["20"][0]
    assert model.source["family"] == "sd15" and patched.source == model.source
    # FreeU shares the loader's tensors and leaves the loader's MODEL as it was.
    assert model.config.freeu is None and patched.config.freeu == (1.3, 1.4, 0.9, 0.2, 2)
    assert patched.module.cfg.freeu == patched.config.freeu
    for (name, p), q in zip(model.module.named_parameters(), patched.module.parameters()):
        assert p.data_ptr() == q.data_ptr(), name
    for nid in ("6", "7"):
        g.assert_close(got[nid][0]["context"], want[nid][0]["context"], f"context {nid}",
                       dict(rtol=2e-4, atol=2e-4))
    assert got["3"][0]["samples"].shape == (2, g.LATENT_HW // 8, g.LATENT_HW // 8, 4)
    g.assert_close(got["3"][0]["samples"], want["3"][0]["samples"], "latent")
    g.assert_close(got["8"][0], want["8"][0], "image")
    saved = got["9"][0]
    assert len(saved) == 2 and all(p.startswith(os.environ["PA_OUTPUT_DIR"]) for p in saved)
