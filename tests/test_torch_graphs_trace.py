"""The graph host's spans and SLO stages in the PyTorch port against the JAX host on
the CPU.

The smallest SD1.5 graph of ``tests/test_torch_graphs_sd15.py`` (txt2img, 2 steps at
32², tiny one-level weights in the public layouts, one sample, ``workload_split``
off) runs through the JAX host and the port's
host, each with its tracer on and inside one prompt's progress scope: each prompt's
multiset of (span name, category, parent span name) is equal, the SLO stage
observations per stage are equal in number, and the latents still agree at that
file's tolerance. The JAX side's ``compile`` spans (one per XLA compile) are left
out: the port compiles its kernels in the ``nvcc`` build, not per program.
"""

import collections

import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401

from comfyui_parallelanything_tpu.utils import slo as jslo  # noqa: E402
from comfyui_parallelanything_tpu.utils import tracing as jtracing  # noqa: E402
from comfyui_parallelanything_tpu.utils.progress import progress_scope as jscope  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import slo as pslo  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import tracing as ptracing  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.progress import (  # noqa: E402
    progress_scope as pscope,
)

import test_torch_graphs_sd15 as graphs  # noqa: E402
from test_torch_graphs_sd15 import assert_close, load_example, run_both  # noqa: E402


@pytest.fixture
def graph_env(tmp_path, monkeypatch):
    """``test_torch_graphs_sd15.py``'s synthetic world with a one-level UNet and VAE:
    the same nodes and spans at about half the JAX side's compile time."""
    monkeypatch.setattr(graphs, "UNET", {**graphs.UNET, "channel_mult": (1,),
                                         "transformer_depth": (1,)})
    monkeypatch.setattr(graphs, "VAE", {**graphs.VAE, "channel_mult": (1,)})
    return graphs.build_graph_env(str(tmp_path), monkeypatch)


def _timeline(export, drop_cat=("compile",)) -> collections.Counter:
    """(name, cat, parent name) of every X event, the parent being the innermost
    span of the same tid that holds it. The save node runs on the port's side only
    (``run_both`` leaves it out of the JAX graph), so its span is left out."""
    xs = [e for e in export["traceEvents"] if e.get("ph") == "X" and e["cat"] not in drop_cat
          and e["args"].get("class_type") != "TPUSaveImage"]
    out = collections.Counter()
    for e in xs:
        holders = [o for o in xs if o is not e and o["tid"] == e["tid"]
                   and o["ts"] <= e["ts"] + 1e-3
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1e-3
                   and (o["dur"], -o["ts"]) > (e["dur"], -e["ts"])]
        parent = min(holders, key=lambda o: o["dur"])["name"] if holders else None
        out[(e["name"], e["cat"], parent)] += 1
    return out


def test_graph_timeline_and_stages_equal_jax(graph_env, cpu_devices, monkeypatch):
    stages = {"jax": collections.Counter(), "port": collections.Counter()}
    monkeypatch.setattr(jslo, "observe_stage", lambda s, v: stages["jax"].update([s]))
    monkeypatch.setattr(pslo, "observe_stage", lambda s, v: stages["port"].update([s]))
    wf = load_example("workflow_sd15_txt2img", graph_env)
    # One sample on the chain's lead device: the same spans and stages, and about a
    # third less of the JAX side's compile time than the two-device split.
    wf["parallel"]["inputs"]["workload_split"] = False
    wf["latent"]["inputs"]["batch_size"] = 1
    jtracing.enable()
    ptracing.enable()
    try:
        with jscope(prompt_id="graph"), pscope(prompt_id="graph"):
            got, want = run_both(wf)
        jx, px = jtracing.export("graph"), ptracing.export("graph")
    finally:
        jtracing.disable()
        ptracing.disable()
        jtracing.tracer.clear()
        ptracing.tracer.clear()
    assert_close(got["sampler"][0]["samples"], want["sampler"][0]["samples"], "latent")
    timeline = _timeline(px)
    assert timeline == _timeline(jx)
    assert timeline[("sampler-run", "sampling", "workflow-node")] == 1
    assert timeline[("step", "sampling", "sampler-run")] == 2
    assert stages["port"] == stages["jax"]
    assert stages["port"]["eval"] == 1 and stages["port"]["encode"] == 2
