"""Standalone workflow-graph executor (counterpart of
``comfyui_parallelanything_tpu/host.py``): runs ComfyUI API-format workflow JSON
against ``nodes.NODE_CLASS_MAPPINGS``, as ComfyUI runs the reference's graphs.

    python -m comfyui_parallelanything_tpu_torch.host graph.json

Format (the ComfyUI ``/prompt`` API shape)::

    {"1": {"class_type": "ParallelDevice",
           "inputs": {"device_id": "cuda:0", "percentage": 100.0}},
     "2": {"class_type": "ParallelAnything",
           "inputs": {"model": ["0", 0], "parallel_devices": ["1", 0]}}, ...}

A two-element list ``[node_id, output_index]`` is a link; anything else is a
literal widget value. As in ComfyUI, a link-shaped value into a declared
primitive widget (INT/FLOAT/STRING/BOOLEAN) is a link too, but only when the id
names a node of the graph, so a genuine two-element list literal stays literal.

Hidden inputs (``INPUT_TYPES()["hidden"]``) are the host's: ``PROMPT`` (the
workflow dict), ``UNIQUE_ID`` (the node id) and, in the port, ``DEVICE``: the
``device`` a run places its weights and latents on (``run_workflow(device=...)``,
default ``cuda:0``; pass ``"cpu"`` to run on the host).

Each executed node (a cached one never runs) is one ``workflow-node`` span
(``utils/tracing.py``), the graph layer of the prompt's timeline, and feeds the
SLO stage of its class (``utils/slo.py``): a node whose class name holds
"Decode" is the ``decode`` stage, "Sampler" the ``eval`` stage, "TextEncode" the
``encode`` stage, each its node's wall on the same clock as the span.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any

from .utils import slo, tracing
from .utils.progress import Interrupted, check_interrupt

DEFAULT_DEVICE = "cuda:0"


class WorkflowError(ValueError):
    """A malformed or unexecutable workflow graph (unknown node or class, bad link,
    cycle), or a node that failed, with the node id in the message."""


class WorkflowCache:
    """Cross-run output cache with ComfyUI-style invalidation.

    Each node's outputs are keyed to a signature over (class_type, literal inputs,
    upstream signatures), so editing a node, or anything upstream of it, re-runs
    exactly the stale subgraph. An evicted value with a ``cleanup()`` (a
    ``ParallelModel``) is torn down, and an evicted CLIP wire releases its embed
    cache entries. Runs execute against a snapshot of the results and merge back
    when they finish, under ``lock``.
    """

    def __init__(self) -> None:
        self.results: dict[str, tuple] = {}  # guarded-by: lock
        self.signatures: dict[str, str] = {}  # guarded-by: lock
        self.lock = threading.RLock()

    def evict(self, nid: str) -> None:
        """Drop one node's outputs (tearing down what no surviving entry shares)."""
        self.evict_stale({nid})

    @staticmethod
    def _teardown(value) -> None:
        cleanup = getattr(value, "cleanup", None)
        if callable(cleanup):
            try:
                cleanup()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        try:
            from .models.embed_cache import release_wire

            release_wire(value)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass

    def evict_stale(self, stale) -> None:
        """Drop every entry in ``stale``. A value is torn down only when no
        surviving entry holds the same object (a node passing its input through
        shares identity with its upstream)."""
        with self.lock:
            stale = set(stale)
            keep_ids = {id(v) for nid, out in self.results.items() if nid not in stale
                        for v in out}
            torn: set[int] = set()
            for nid in stale:
                out = self.results.pop(nid, None)
                self.signatures.pop(nid, None)
                for value in out or ():
                    if id(value) in keep_ids or id(value) in torn:
                        continue
                    torn.add(id(value))
                    self._teardown(value)

    def snapshot(self, sigs: dict[str, str]) -> dict[str, tuple]:
        """Evict the entries stale against this run's signatures and return a copy
        of the survivors for the run."""
        with self.lock:
            self.evict_stale(nid for nid in self.results
                             if nid not in sigs or self.signatures.get(nid) != sigs[nid])
            return dict(self.results)

    def merge(self, results: dict[str, tuple], sigs: dict[str, str]) -> None:
        """Bank one run's (possibly partial) outputs. An incumbent with the same
        signature stays, and the caller's duplicate is not torn down (the caller
        still holds it); an incumbent with another signature is evicted first."""
        with self.lock:
            for nid, out in results.items():
                prev = self.results.get(nid)
                if prev is not None and self.signatures.get(nid) == sigs.get(nid):
                    continue
                if prev is not None:
                    self.evict_stale({nid})
                self.results[nid] = out
                self.signatures[nid] = sigs[nid]


def _is_link(v: Any) -> bool:
    return (isinstance(v, list) and len(v) == 2 and isinstance(v[0], (str, int))
            and isinstance(v[1], int))


_WIDGET_PRIMITIVES = {"INT", "FLOAT", "STRING", "BOOLEAN"}


def _wire_inputs(cls: type) -> tuple[set[str], set[str], dict[str, str]]:
    """(wire input names, declared input names, hidden inputs) from one call of a
    node's ``INPUT_TYPES``. A declared widget (a primitive type or a dropdown)
    takes literals, a declared wire type (e.g. ``"MODEL"``) takes links;
    undeclared names fall back to the link shape."""
    wires: set[str] = set()
    declared: set[str] = set()
    hidden: dict[str, str] = {}
    try:
        spec = cls.INPUT_TYPES()
    except Exception:  # noqa: BLE001 - a node without a declaration takes link shapes
        return wires, declared, hidden
    for key, group in spec.items():
        if not isinstance(group, dict):
            continue
        if key == "hidden":
            hidden = {k: v for k, v in group.items() if isinstance(v, str)}
            continue
        for name, decl in group.items():
            declared.add(name)
            typ = decl[0] if isinstance(decl, (tuple, list)) and decl else decl
            if isinstance(typ, str) and typ not in _WIDGET_PRIMITIVES:
                wires.add(name)
    return wires, declared, hidden


STAGES = ("encode", "denoise", "decode")


def _intrinsic_stage(class_type) -> int | None:
    """Stage rank of a node class by its name ("Decode" → decode, "Sampler" →
    denoise, "TextEncode" → encode, checked in that order), None for neutral
    nodes."""
    ct = str(class_type or "")
    if "Decode" in ct:
        return 2
    if "Sampler" in ct:
        return 1
    if "TextEncode" in ct:
        return 0
    return None


def carve_stages(workflow) -> dict | None:
    """Carve a graph into encode / denoise / decode sub-plans (stage-level placement
    for role pools). Links are found by shape and the id naming a graph node;
    ranks come from ``_intrinsic_stage``. A neutral node inherits the highest rank
    among its ancestors; a node with no ranked ancestor (a loader) replicates into
    every stage's closure. Each stage's ``graph`` is the full upstream closure of
    its members.

    Returns None when the graph does not split cleanly: fewer than two stages
    present, a cycle, a malformed spec, or a stage order that is not monotone
    along some edge (a Decode feeding a second Sampler). Otherwise
    ``{"stages": [{"stage", "nodes", "graph", "needs", "exports"}, ...]}``, where
    ``needs`` are earlier stages' node ids this stage takes as inputs and
    ``exports`` this stage's node ids a later stage needs."""
    if not isinstance(workflow, dict):
        return None
    graph = {str(k): v for k, v in workflow.items()}
    deps: dict[str, list[str]] = {}
    for nid, spec in graph.items():
        if not isinstance(spec, dict):
            return None
        ds: list[str] = []
        for v in (spec.get("inputs") or {}).values():
            if _is_link(v) and str(v[0]) in graph and str(v[0]) not in ds:
                ds.append(str(v[0]))
        deps[nid] = ds
    # Kahn's topological order; leftovers mean a cycle.
    indeg = {nid: len(ds) for nid, ds in deps.items()}
    rdeps: dict[str, list[str]] = {nid: [] for nid in graph}
    for nid, ds in deps.items():
        for d in ds:
            rdeps[d].append(nid)
    ready = sorted(nid for nid, n in indeg.items() if n == 0)
    topo: list[str] = []
    while ready:
        nid = ready.pop(0)
        topo.append(nid)
        for child in rdeps[nid]:
            indeg[child] -= 1
            if indeg[child] == 0:
                ready.append(child)
    if len(topo) != len(graph):
        return None
    rank: dict[str, int | None] = {}
    intrinsic_present: set[int] = set()
    for nid in topo:
        anc = max((rank[d] for d in deps[nid] if rank.get(d) is not None), default=None)
        r = _intrinsic_stage(graph[nid].get("class_type"))
        if r is None:
            rank[nid] = anc
        else:
            intrinsic_present.add(r)
            if anc is not None and anc > r:
                return None
            rank[nid] = r
    if len(intrinsic_present) < 2:
        return None
    stages = []
    for s in sorted({r for r in rank.values() if r is not None}):
        members = [nid for nid in topo if rank[nid] == s]
        closure: dict[str, Any] = {}
        stack = list(members)
        while stack:
            nid = stack.pop()
            if nid in closure:
                continue
            closure[nid] = graph[nid]
            stack.extend(deps[nid])
        needs = sorted({d for m in members for d in deps[m]
                        if rank.get(d) is not None and rank[d] < s})
        stages.append({"stage": STAGES[s], "nodes": members, "graph": closure,
                       "needs": needs, "exports": []})
    by_rank = {st["stage"]: st for st in stages}
    for st in stages:
        for d in st["needs"]:
            owner = by_rank[STAGES[rank[d]]]
            if d not in owner["exports"]:
                owner["exports"].append(d)
    for st in stages:
        st["exports"].sort()
    return {"stages": stages}


def run_workflow(workflow: Any, class_mappings: dict[str, type] | None = None,
                 outputs: dict[str, tuple] | WorkflowCache | None = None, on_node=None,
                 on_cached=None, preseed: dict[str, tuple] | None = None,
                 device: str = DEFAULT_DEVICE) -> dict[str, tuple]:
    """Execute a ComfyUI API-format workflow; returns ``{node_id: outputs}``.

    ``workflow`` is the dict or a path to a JSON file. ``class_mappings`` extends or
    overrides ``nodes.NODE_CLASS_MAPPINGS``. ``outputs`` pre-seeds results: a plain
    dict is reused as it is (only the nodes not in it run); a ``WorkflowCache``
    adds invalidation (stale or dropped entries are evicted and torn down, only
    the changed subgraph runs; the graph must be acyclic). ``device`` is what the
    hidden ``DEVICE`` inputs receive: where the loaders place weights and the
    empty latents and loaded images land (default ``cuda:0``).

    ``on_node(nid)`` fires just before each node runs (cached nodes are skipped:
    ComfyUI's ``executing`` event); ``on_cached(nids)`` fires once before the run
    with the sorted ids served from ``outputs``. The interrupt
    (``utils/progress``) is checked before every node, and ``Interrupted`` raised
    inside a node propagates unwrapped; any other failure becomes a
    ``WorkflowError`` naming the node. ``preseed`` force-seeds results after the
    cache snapshot (the stage hand-off of ``carve_stages``) and is banked like any
    other result.
    """
    from .nodes import NODE_CLASS_MAPPINGS

    classes: dict[str, type] = dict(NODE_CLASS_MAPPINGS)
    classes.update(class_mappings or {})
    if isinstance(workflow, (str, os.PathLike)):
        with open(workflow) as f:
            workflow = json.load(f)
    if not isinstance(workflow, dict):
        raise WorkflowError(f"workflow must be a dict, got {type(workflow).__name__}")
    graph = {str(k): v for k, v in workflow.items()}
    cache = outputs if isinstance(outputs, WorkflowCache) else None
    results: dict[str, tuple] = {} if cache is not None else dict(outputs or {})

    def node_class(nid: str) -> tuple[dict, type]:
        spec = graph.get(nid)
        if spec is None:
            raise WorkflowError(f"link references unknown node id {nid!r}")
        if not isinstance(spec, dict):
            raise WorkflowError(f"node {nid}: spec must be a dict with class_type/inputs, "
                                f"got {type(spec).__name__}")
        cls = classes.get(spec.get("class_type"))
        if cls is None:
            raise WorkflowError(f"node {nid}: unknown class_type {spec.get('class_type')!r} "
                                f"(registered: {sorted(classes)})")
        return spec, cls

    def link_inputs(spec: dict, cls: type):
        """(links, hidden): the inputs taken from another node's output, and the
        host-filled hidden group."""
        wires, declared, hidden = _wire_inputs(cls)
        links: dict[str, tuple[str, int]] = {}
        for name, v in (spec.get("inputs") or {}).items():
            if _is_link(v) and (name in wires or name not in declared or str(v[0]) in graph):
                links[name] = (str(v[0]), int(v[1]))
        return links, hidden

    def postorder(root: str, is_done, visit) -> None:
        """Iterative post-order walk over the links (a deep graph cannot overflow
        Python's recursion); ``visit(nid, spec, cls, links, hidden)`` runs once per
        node after its dependencies; a cycle raises ``WorkflowError``."""
        stack: list[list] = [[root, None]]
        path: list[str] = []
        on_path: set[str] = set()
        while stack:
            nid, resolved = stack[-1]
            if resolved is None:
                if is_done(nid):
                    stack.pop()
                    continue
                if nid in on_path:
                    raise WorkflowError(f"cycle in workflow: {' -> '.join(path)} -> {nid}")
                spec, cls = node_class(nid)
                links, hidden = link_inputs(spec, cls)
                stack[-1][1] = (spec, cls, links, hidden)
                path.append(nid)
                on_path.add(nid)
                for dep in reversed(list(dict.fromkeys(dep for dep, _ in links.values()))):
                    if not is_done(dep):
                        stack.append([dep, None])
                continue
            spec, cls, links, hidden = resolved
            visit(nid, spec, cls, links, hidden)
            on_path.discard(nid)
            path.pop()
            stack.pop()

    def compute_signatures() -> dict[str, str]:
        """Per-node content signature over (class_type, literal inputs, upstream
        signatures, and the host's device where the node takes the hidden
        ``DEVICE``: it decides where the node places its outputs), over the whole
        graph; raises on cycles."""
        sigs: dict[str, str] = {}

        def visit(nid, spec, cls, links, hidden):
            canon: dict[str, Any] = {}
            for name, v in (spec.get("inputs") or {}).items():
                if name in links:
                    dep, idx = links[name]
                    canon[name] = ["__link__", sigs[dep], idx]
                else:
                    canon[name] = v
            placed = device if "DEVICE" in hidden.values() else None
            blob = json.dumps([spec.get("class_type"), canon, placed], sort_keys=True,
                              default=repr)
            sigs[nid] = hashlib.sha1(blob.encode()).hexdigest()

        for root in graph:
            postorder(root, sigs.__contains__, visit)
        return sigs

    if cache is not None:
        sigs = compute_signatures()
        results = cache.snapshot(sigs)
    if preseed:
        results.update({str(k): tuple(v) for k, v in preseed.items() if str(k) in graph})
    if on_cached is not None:
        cached = sorted(nid for nid in graph if nid in results)
        if cached:
            on_cached(cached)

    def exec_visit(nid, spec, cls, links, hidden):
        kwargs: dict[str, Any] = {}
        for name, v in (spec.get("inputs") or {}).items():
            if name in links:
                dep, idx = links[name]
                upstream = results[dep]
                if idx < 0 or idx >= len(upstream):
                    raise WorkflowError(
                        f"node {nid}: input {name!r} wants output {idx} of node {dep}, "
                        f"which has {len(upstream)} output(s) (indices must be non-negative)")
                kwargs[name] = upstream[idx]
            else:
                kwargs[name] = v
        # Hidden values go in last: they win over same-named graph inputs.
        for name, typ in hidden.items():
            kwargs[name] = {"PROMPT": graph, "UNIQUE_ID": nid, "DEVICE": device}.get(typ)
        # The interrupt at node granularity: a Cancel inside a non-sampler node
        # stops the graph before the next node runs.
        check_interrupt(f"before node {nid}")
        if on_node is not None:
            on_node(nid)
        fn = getattr(cls(), cls.FUNCTION)
        try:
            ct = str(spec.get("class_type") or "")
            t0_node = time.monotonic() if slo.enabled() else 0.0
            with tracing.span("workflow-node", cat="graph", node=nid,
                              class_type=spec.get("class_type")):
                out = fn(**kwargs)
            if slo.enabled():
                # The stage by node class: the same boundary the span measures.
                stage = ("decode" if "Decode" in ct else "eval" if "Sampler" in ct
                         else "encode" if "TextEncode" in ct else None)
                if stage is not None:
                    slo.observe_stage(stage, time.monotonic() - t0_node)
        except (WorkflowError, Interrupted):
            raise
        except Exception as e:
            raise WorkflowError(
                f"node {nid} ({spec.get('class_type')}): {type(e).__name__}: {e}") from e
        if not isinstance(out, tuple):
            out = (out,)
        results[nid] = out

    try:
        for nid in graph:
            postorder(nid, results.__contains__, exec_visit)
    finally:
        if cache is not None:
            # Completed nodes stay banked even after an error or an interrupt.
            cache.merge({nid: results[nid] for nid in graph if nid in results}, sigs)
    return results


def main(argv: list[str] | None = None) -> None:
    """``python -m comfyui_parallelanything_tpu_torch.host [--device cpu] graph.json``:
    run a workflow file (on ``cuda:0`` unless ``--device`` names another device)
    and print each node's output types."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m comfyui_parallelanything_tpu_torch.host")
    ap.add_argument("workflow")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where weights and latents go (default cuda:0; 'cpu' for the host)")
    args = ap.parse_args(argv)
    results = run_workflow(args.workflow, device=args.device)
    for nid, out in results.items():
        print(f"{nid}: {tuple(type(o).__name__ for o in out)}")


if __name__ == "__main__":
    main()
