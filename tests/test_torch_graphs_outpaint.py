"""``workflow_sd15_inpaint_outpaint`` end to end through both graph hosts (the port's
on the CPU over ``cpu:0`` + ``cpu:1``, the JAX package's), on the tiny SD1.5 world of
``test_torch_graphs_sd15`` and its injected noise: a 40² PNG through
``TPULoadImage``, ``ImagePadForOutpaint`` (64 px left and right, the 16 px quadratic
feather), ``VAEEncodeForInpaint`` (the mask grown by 6), 2 sampler steps, the decode
and ``ImageCompositeMasked``'s paste back, compared node output by node output. The
paste equals the padded source exactly where the mask is 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import test_torch_graphs_sd15 as g  # noqa: E402

graph_env = g.graph_env
EXACT = dict(rtol=0, atol=0)


def test_outpaint_matches_jax(graph_env, cpu_devices):
    from PIL import Image

    src = f"{graph_env['tmp']}/input.png"
    Image.fromarray((np.random.default_rng(1).uniform(0, 1, (40, 40, 3)) * 255)
                    .astype(np.uint8)).save(src)
    wf = g.load_example("workflow_sd15_inpaint_outpaint", graph_env)
    wf["source"]["inputs"]["image_path"] = src
    got, want = g.run_both(wf)
    assert got["parallel"][0].devices == ("cpu:0", "cpu:1")
    padded, mask = got["outpaint_pad"]
    assert padded.shape == (1, 40, 168, 3) and mask.shape == (1, 40, 168)
    g.assert_close(padded, want["outpaint_pad"][0], "padded", EXACT)
    g.assert_close(mask, want["outpaint_pad"][1], "mask", dict(rtol=1e-6, atol=1e-6))
    assert 0.0 < float(mask[0, 20, 64 + 8]) < 1.0  # the feather reaches into the source
    enc, jenc = got["encode_inpaint"][0], want["encode_inpaint"][0]
    g.assert_close(enc["noise_mask"], jenc["noise_mask"], "noise_mask", EXACT)
    g.assert_close(enc["samples"], jenc["samples"], "masked latent", dict(rtol=2e-4, atol=2e-4))
    g.assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    g.assert_close(got["decode"][0], want["decode"][0], "decode")
    out = got["paste_back"][0]
    g.assert_close(out, want["paste_back"][0], "paste_back")
    keep = (mask == 0)[..., None].expand_as(out)
    assert keep.any() and torch.equal(out[keep], padded[keep])
    g.assert_saved(got, 1)
