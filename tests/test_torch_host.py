"""The port's graph executor (``host.py``) against the JAX package's: the JAX
executor's toy-node cases (``tests/test_host_graph.py``: links, literals, cycles,
hidden inputs, the output cache and ``WorkflowCache`` invalidation and teardown,
the interrupt) and ``carve_stages`` (``tests/test_roles.py::TestCarveStages``),
each run through both hosts with the same outcome. No model is needed. Then the
port's own surface: the hidden ``DEVICE`` input, a device the port does not have,
the embed-cache release on eviction and the ``python -m`` entry point."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu import host as jhost  # noqa: E402
from comfyui_parallelanything_tpu.utils import progress as jprogress  # noqa: E402
from comfyui_parallelanything_tpu_torch import host as phost  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import progress as pprogress  # noqa: E402

HOSTS = {"jax": (jhost, jprogress), "port": (phost, pprogress)}


@pytest.fixture(params=sorted(HOSTS))
def host(request):
    h, prog = HOSTS[request.param]
    yield h
    prog.clear_interrupt()


def _chain_workflow():
    return {
        "1": {"class_type": "ParallelDevice",
              "inputs": {"device_id": "cpu:0", "percentage": 50.0}},
        "2": {"class_type": "ParallelDevice",
              "inputs": {"device_id": "cpu:1", "percentage": 50.0,
                         "previous_devices": ["1", 0]}},
    }


class TestExecutor:
    def test_chain_graph(self, host):
        out = host.run_workflow(_chain_workflow())
        assert [e["device"] for e in out["2"][0]] == ["cpu:0", "cpu:1"]
        assert out["1"][0][0]["percentage"] == 50.0

    def test_unknown_class_raises(self, host):
        with pytest.raises(host.WorkflowError, match="unknown class_type"):
            host.run_workflow({"1": {"class_type": "NoSuchNode", "inputs": {}}})

    def test_pending_interrupt_stops_before_next_node(self, host):
        prog = HOSTS["jax" if host is jhost else "port"][1]
        prog.request_interrupt()
        try:
            with pytest.raises(prog.Interrupted, match="before node"):
                host.run_workflow(_chain_workflow())
        finally:
            prog.clear_interrupt()
        assert host.run_workflow(_chain_workflow())["2"][0]

    def test_unknown_link_target_raises(self, host):
        wf = {"1": {"class_type": "ParallelDevice",
                    "inputs": {"device_id": "cpu:0", "percentage": 50.0,
                               "previous_devices": ["99", 0]}}}
        with pytest.raises(host.WorkflowError, match="unknown node id"):
            host.run_workflow(wf)

    def test_cycle_raises(self, host):
        wf = _chain_workflow()
        wf["1"]["inputs"]["previous_devices"] = ["2", 0]
        with pytest.raises(host.WorkflowError, match="cycle"):
            host.run_workflow(wf)

    def test_out_of_range_output_raises(self, host):
        wf = _chain_workflow()
        wf["2"]["inputs"]["previous_devices"] = ["1", 3]
        with pytest.raises(host.WorkflowError, match="3 .* 1 output"):
            host.run_workflow(wf)

    def test_widget_list_literal_not_mistaken_for_link(self, host):
        seen = {}

        class Sizer:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            @classmethod
            def INPUT_TYPES(cls):
                return {"required": {"size": ("INT", {}), "pair": ("FLOAT", {})}}

            def go(self, size, pair):
                seen["pair"] = pair
                return (size,)

        wf = {"7": {"class_type": "Sizer", "inputs": {"size": 3, "pair": [64, 0]}}}
        assert host.run_workflow(wf, {"Sizer": Sizer})["7"] == (3,)
        assert seen["pair"] == [64, 0]

    def test_linked_primitive_widget_resolves(self, host):
        class SeedSource:
            RETURN_TYPES = ("INT",)
            FUNCTION = "go"

            def go(self):
                return (1234,)

        class Consumer:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            @classmethod
            def INPUT_TYPES(cls):
                return {"required": {"seed": ("INT", {})}}

            def go(self, seed):
                return (seed,)

        wf = {"a": {"class_type": "SeedSource", "inputs": {}},
              "b": {"class_type": "Consumer", "inputs": {"seed": ["a", 0]}}}
        out = host.run_workflow(wf, {"SeedSource": SeedSource, "Consumer": Consumer})
        assert out["b"] == (1234,)

    def test_deep_chain_no_recursion_limit(self, host):
        class Inc:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            @classmethod
            def INPUT_TYPES(cls):
                return {"required": {"x": ("X", {})}}

            def go(self, x):
                return (x + 1,)

        n = 3000
        wf = {"0": {"class_type": "Inc", "inputs": {"x": -1}}}
        for i in range(1, n):
            wf[str(i)] = {"class_type": "Inc", "inputs": {"x": [str(i - 1), 0]}}
        assert host.run_workflow(wf, {"Inc": Inc})[str(n - 1)] == (n - 1,)

    def test_node_error_carries_node_id(self, host):
        wf = {"9": {"class_type": "ParallelDevice", "inputs": {"percentage": 50.0}}}
        with pytest.raises(host.WorkflowError, match="node 9"):
            host.run_workflow(wf)

    def test_output_cache_skips_execution(self, host):
        ran = []

        class Probe:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            def go(self):
                ran.append(1)
                return ("value",)

        out = host.run_workflow({"1": {"class_type": "Probe", "inputs": {}}},
                                {"Probe": Probe}, outputs={"1": ("cached",)})
        assert out["1"] == ("cached",) and not ran

    def test_json_file_roundtrip(self, host, tmp_path):
        p = tmp_path / "wf.json"
        p.write_text(json.dumps(_chain_workflow()))
        assert len(host.run_workflow(str(p))["2"][0]) == 2

    def test_on_node_and_on_cached(self, host):
        ran, cached = [], []
        out = host.run_workflow(_chain_workflow(), on_node=ran.append)
        assert ran == ["1", "2"]
        host.run_workflow(_chain_workflow(), outputs={"1": out["1"]}, on_node=ran.append,
                          on_cached=cached.append)
        assert ran == ["1", "2", "2"] and cached == [["1"]]


class TestHiddenInputs:
    def test_prompt_and_unique_id_injected(self, host):
        seen = {}

        class Probe:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            @classmethod
            def INPUT_TYPES(cls):
                return {"required": {}, "hidden": {"prompt": "PROMPT", "uid": "UNIQUE_ID"}}

            def go(self, prompt=None, uid=None):
                seen.update(prompt=prompt, uid=uid)
                return (1,)

        host.run_workflow({"p9": {"class_type": "Probe", "inputs": {}}}, {"Probe": Probe})
        assert seen["uid"] == "p9"
        assert seen["prompt"]["p9"]["class_type"] == "Probe"

    def test_save_image_embeds_workflow_prompt(self, host, tmp_path):
        from PIL import Image

        class Gen:
            RETURN_TYPES = ("IMAGE",)
            FUNCTION = "go"

            def go(self):
                return (np.full((1, 4, 4, 3), 0.25, np.float32),)

        wf = {"g": {"class_type": "Gen", "inputs": {}},
              "s": {"class_type": "TPUSaveImage",
                    "inputs": {"images": ["g", 0], "filename_prefix": "w",
                               "output_dir": str(tmp_path)}}}
        (path,) = host.run_workflow(wf, {"Gen": Gen})["s"][0]
        embedded = json.loads(Image.open(path).text["prompt"])
        assert embedded["s"]["class_type"] == "TPUSaveImage"
        assert embedded["g"]["class_type"] == "Gen"
        assert np.asarray(Image.open(path)).max() == 64  # 0.25 · 255, rounded


class _Model:
    """A teardownable output (the shape ParallelModel exposes)."""

    def __init__(self):
        self.active = True

    def cleanup(self):
        self.active = False


def _cache_classes(built):
    class Build:
        RETURN_TYPES = ("MODEL",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"tag": ("STRING", {})}}

        def go(self, tag):
            m = _Model()
            built.append((tag, m))
            return (m,)

    class Use:
        RETURN_TYPES = ("X",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"model": ("MODEL", {})}}

        def go(self, model):
            return (model,)

    class Tag:
        RETURN_TYPES = ("MODEL",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"model": ("MODEL", {}), "note": ("STRING", {})}}

        def go(self, model, note):
            return (model,)  # pass-through

    return {"Build": Build, "Use": Use, "Tag": Tag}


def _cache_wf(tag):
    return {"m": {"class_type": "Build", "inputs": {"tag": tag}},
            "u": {"class_type": "Use", "inputs": {"model": ["m", 0]}}}


class TestWorkflowCache:
    def test_unchanged_graph_reuses_cache(self, host):
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()
        host.run_workflow(_cache_wf("a"), classes, outputs=cache)
        host.run_workflow(_cache_wf("a"), classes, outputs=cache)
        assert len(built) == 1 and built[0][1].active

    def test_changed_input_evicts_and_tears_down(self, host):
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()
        host.run_workflow(_cache_wf("a"), classes, outputs=cache)
        out2 = host.run_workflow(_cache_wf("b"), classes, outputs=cache)
        assert [t for t, _ in built] == ["a", "b"]
        assert not built[0][1].active and built[1][1].active
        assert out2["u"][0] is built[1][1]

    def test_dropped_node_evicts(self, host):
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()
        host.run_workflow(_cache_wf("a"), classes, outputs=cache)
        host.run_workflow({"other": {"class_type": "Build", "inputs": {"tag": "z"}}},
                          classes, outputs=cache)
        assert not built[0][1].active
        assert "m" not in cache.results and "u" not in cache.results

    def test_passthrough_eviction_spares_shared_model(self, host):
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()

        def wf(note):
            return {"m": {"class_type": "Build", "inputs": {"tag": "a"}},
                    "t": {"class_type": "Tag", "inputs": {"model": ["m", 0], "note": note}}}

        host.run_workflow(wf("one"), classes, outputs=cache)
        model = built[0][1]
        host.run_workflow(wf("two"), classes, outputs=cache)
        assert len(built) == 1 and model.active
        assert cache.results["t"][0] is model

    def test_downstream_only_change_keeps_upstream_cache(self, host):
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()
        host.run_workflow(_cache_wf("a"), classes, outputs=cache)
        wf2 = _cache_wf("a")
        wf2["u2"] = {"class_type": "Use", "inputs": {"model": ["m", 0]}}
        host.run_workflow(wf2, classes, outputs=cache)
        assert len(built) == 1 and built[0][1].active

    def test_interrupted_run_banks_completed_nodes(self, host):
        prog = HOSTS["jax" if host is jhost else "port"][1]
        built = []
        classes, cache = _cache_classes(built), host.WorkflowCache()

        class Stop:
            RETURN_TYPES = ("X",)
            FUNCTION = "go"

            @classmethod
            def INPUT_TYPES(cls):
                return {"required": {"model": ("MODEL", {})}}

            def go(self, model):
                prog.request_interrupt()
                return (model,)

        wf = {**_cache_wf("a"), "s": {"class_type": "Stop", "inputs": {"model": ["m", 0]}},
              "z": {"class_type": "Use", "inputs": {"model": ["s", 0]}}}
        with pytest.raises(prog.Interrupted):
            host.run_workflow(wf, {**classes, "Stop": Stop}, outputs=cache)
        assert "m" in cache.results and "z" not in cache.results


def _sgraph(seed, text="a castle"):
    """The canonical 3-stage workflow: TextEncode → Sampler → Decode."""
    return {
        "1": {"class_type": "ToyTextEncode", "inputs": {"text": str(text), "work_s": 0.0}},
        "2": {"class_type": "ToySampler",
              "inputs": {"cond": ["1", 0], "seed": int(seed), "work_s": 0.0}},
        "3": {"class_type": "ToyDecode",
              "inputs": {"latent": ["2", 0], "seed": int(seed), "work_s": 0.0}},
    }


class TestCarveStages:
    def test_three_stage_carve(self, host):
        plan = host.carve_stages(_sgraph(1))
        assert [s["stage"] for s in plan["stages"]] == ["encode", "denoise", "decode"]
        enc, den, dec = plan["stages"]
        assert (enc["nodes"], enc["needs"], enc["exports"]) == (["1"], [], ["1"])
        assert (den["nodes"], den["needs"], den["exports"]) == (["2"], ["1"], ["2"])
        assert (dec["nodes"], dec["needs"], dec["exports"]) == (["3"], ["2"], [])
        assert set(enc["graph"]) == {"1"}
        assert set(den["graph"]) == {"1", "2"}
        assert set(dec["graph"]) == {"1", "2", "3"}

    def test_neutral_node_inherits_max_ancestor_rank(self, host):
        g = _sgraph(2)
        g["4"] = {"class_type": "ToySave", "inputs": {"x": ["3", 0]}}
        dec = host.carve_stages(g)["stages"][2]
        assert set(dec["nodes"]) == {"3", "4"} and dec["needs"] == ["2"]

    def test_free_loader_rides_dependent_closures(self, host):
        g = _sgraph(3)
        g["0"] = {"class_type": "ToyLoader", "inputs": {}}
        g["2"]["inputs"]["model"] = ["0", 0]
        enc, den, dec = host.carve_stages(g)["stages"]
        assert "0" not in enc["graph"] and "0" in den["graph"] and "0" in dec["graph"]
        for st in (enc, den, dec):
            assert "0" not in st["nodes"] and "0" not in st["needs"]

    def test_fewer_than_two_intrinsic_stages_no_carve(self, host):
        assert host.carve_stages({"1": {"class_type": "SleepWork", "inputs": {}}}) is None
        assert host.carve_stages({"1": {"class_type": "ToySampler",
                                        "inputs": {"seed": 1}}}) is None

    def test_cycle_no_carve(self, host):
        g = {"1": {"class_type": "ToyTextEncode", "inputs": {"text": "x"}},
             "2": {"class_type": "ToySampler", "inputs": {"cond": ["1", 0], "latent": ["3", 0]}},
             "3": {"class_type": "ToyDecode", "inputs": {"latent": ["2", 0]}}}
        assert host.carve_stages(g) is None

    def test_non_monotone_highres_fix_no_carve(self, host):
        g = _sgraph(4)
        g["4"] = {"class_type": "ToySampler", "inputs": {"cond": ["3", 0], "seed": 4}}
        assert host.carve_stages(g) is None

    def test_malformed_graph_no_carve(self, host):
        assert host.carve_stages(None) is None
        assert host.carve_stages({"1": "not-a-node"}) is None

    def test_shipped_examples_carve_alike(self, host):
        import glob

        for path in sorted(glob.glob("examples/*.json")):
            with open(path) as f:
                wf = json.load(f)
            want = jhost.carve_stages(wf)
            assert phost.carve_stages(wf) == want, path
            assert host.carve_stages(wf) == want


class _DeviceProbe:
    RETURN_TYPES = ("X",)
    FUNCTION = "go"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}, "hidden": {"device": "DEVICE"}}

    def go(self, device=None):
        return (device,)


def test_hidden_device_input_defaults_to_the_card():
    wf = {"d": {"class_type": "Probe", "inputs": {}}}
    assert phost.run_workflow(wf, {"Probe": _DeviceProbe})["d"] == ("cuda:0",)
    assert phost.run_workflow(wf, {"Probe": _DeviceProbe}, device="cpu")["d"] == ("cpu",)
    # A graph input of the same name does not override the host's value.
    wf["d"]["inputs"]["device"] = "cuda:3"
    assert phost.run_workflow(wf, {"Probe": _DeviceProbe}, device="cpu")["d"] == ("cpu",)


def test_cache_keys_each_placed_output_by_its_device():
    # One cache across two devices: a node taking the hidden DEVICE, and every node
    # downstream of it, runs again on the other device; a node that does not take it
    # stays banked.
    calls = []

    class Lit:
        RETURN_TYPES = ("X",)
        FUNCTION = "go"

        def go(self):
            calls.append("lit")
            return ("lit",)

    class Placed(_DeviceProbe):
        def go(self, device=None):
            calls.append(device)
            return (device,)

    class Use:
        RETURN_TYPES = ("X",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"x": ("X", {})}}

        def go(self, x):
            calls.append(f"use {x}")
            return (f"used on {x}",)

    classes = {"Lit": Lit, "Placed": Placed, "Use": Use}
    wf = {"l": {"class_type": "Lit", "inputs": {}},
          "p": {"class_type": "Placed", "inputs": {}},
          "u": {"class_type": "Use", "inputs": {"x": ["p", 0]}}}
    cache = phost.WorkflowCache()
    assert phost.run_workflow(wf, classes, outputs=cache, device="cpu")["u"] == ("used on cpu",)
    assert phost.run_workflow(wf, classes, outputs=cache, device="cpu:1")["u"] == (
        "used on cpu:1",)
    assert phost.run_workflow(wf, classes, outputs=cache, device="cpu:1")["p"] == ("cpu:1",)
    assert calls == ["lit", "cpu", "use cpu", "cpu:1", "use cpu:1"]


@pytest.mark.parametrize("device_id", ["tpu:0", "cuda:banana", "gpu", "cpu:8"])
def test_a_device_the_port_does_not_have_raises(device_id):
    # The JAX node passes it on and parallelize drops it; the port's node refuses it.
    wf = {"1": {"class_type": "ParallelDevice",
                "inputs": {"device_id": device_id, "percentage": 100.0}},
          "2": {"class_type": "ParallelAnything",
                "inputs": {"model": ["m", 0], "parallel_devices": ["1", 0]}},
          "m": {"class_type": "Model", "inputs": {}}}

    class Model:
        RETURN_TYPES = ("MODEL",)
        FUNCTION = "go"

        def go(self):
            return (torch.nn.Linear(2, 2),)

    with pytest.raises(phost.WorkflowError, match="node 1 .*ValueError.*offers"):
        phost.run_workflow(wf, {"Model": Model}, device="cpu")


def test_loaders_default_to_the_card_without_one():
    # No silent CPU fallback: a loader asked for cuda:0 on a machine without a GPU
    # raises (the host's default), and says how to ask for the CPU.
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    wf = {"l": {"class_type": "TPUEmptyLatent",
                "inputs": {"width": 16, "height": 16, "batch_size": 1}}}
    with pytest.raises(phost.WorkflowError, match="No devices available|no CUDA device"):
        phost.run_workflow(wf)
    assert phost.run_workflow(wf, device="cpu")["l"][0]["samples"].shape == (1, 2, 2, 4)


def test_evicted_clip_wire_releases_its_embeds():
    from comfyui_parallelanything_tpu_torch.models import embed_cache

    class Enc:
        cfg = None

    class Clip:
        RETURN_TYPES = ("CLIP",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"tag": ("STRING", {})}}

        def go(self, tag):
            enc = Enc()
            embed_cache.cached_encode(enc, None, "clip-l", np.arange(4), None,
                                      lambda: torch.ones(3))
            return ({"encoder": enc},)

    embed_cache.cache.clear()
    cache = phost.WorkflowCache()
    phost.run_workflow({"c": {"class_type": "Clip", "inputs": {"tag": "a"}}}, {"Clip": Clip},
                       outputs=cache)
    assert embed_cache.cache.stats()["entries"] == 1
    phost.run_workflow({"c": {"class_type": "Clip", "inputs": {"tag": "b"}}}, {"Clip": Clip},
                       outputs=cache)
    assert embed_cache.cache.stats()["entries"] == 1  # a's entry left with its wire
    embed_cache.cache.clear()


def test_main_runs_a_graph_file_on_the_requested_device(tmp_path, capsys):
    p = tmp_path / "wf.json"
    p.write_text(json.dumps(_chain_workflow()))
    phost.main([str(p), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == ["1: ('list',)", "2: ('list',)"]
