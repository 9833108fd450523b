"""The port's copies of the host layers (obs, egress, online, fleet, configs,
the training data pipeline, the dry-run's report) against their
originals: the source is the same program once the `repro.` imports read
`repro_torch.` (compared by AST), and the same access stream through
either package bills, hits and audits alike."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import repro.core as rcore
import repro.egress as regress
import repro.obs as robs
import repro.online as ronline
import repro_torch.core as tcore
import repro_torch.egress as tegress
import repro_torch.obs as tobs
import repro_torch.online as tonline

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
COPIES = [f"{pkg}/{name}.py" for pkg, names in [
    ("obs", ["__init__", "metrics", "trace", "events", "schema"]),
    ("egress", ["__init__", "store", "cache"]),
    ("online", ["__init__", "metrics", "shadow", "window", "admission",
                "governor", "scenario"]),
    ("fleet", ["__init__", "wire", "gossip", "node", "coordinator"]),
    ("configs", ["chatglm3_6b", "gemma3_4b", "kimi_k2_1t_a32b",
                 "mistral_nemo_12b", "phi4_mini_3_8b", "qwen2_moe_a2_7b",
                 "qwen2_vl_72b", "recurrentgemma_9b", "whisper_large_v3",
                 "xlstm_125m"]),
    ("train", ["data"]),
    ("launch", ["report"]),
] for name in names]


class _PortImports(ast.NodeTransformer):
    """Rewrite `repro.x` in import statements to `repro_torch.x`."""

    @staticmethod
    def _port(name):
        return "repro_torch." + name[len("repro."):] \
            if name and name.startswith("repro.") else name

    def visit_ImportFrom(self, node):
        node.module = self._port(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._port(alias.name)
        return node


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_with_port_imports(path):
    original = _PortImports().visit(ast.parse((SRC / "repro" / path)
                                              .read_text()))
    copy = ast.parse((SRC / "repro_torch" / path).read_text())
    assert ast.dump(copy) == ast.dump(original)


def _trace(sizes: str):
    tr = rcore.zipf_trace(n_objects=60, n_requests=700, alpha=0.9, seed=11)
    if sizes == "uniform":
        return tr.ids, np.full(tr.num_objects, 4096.0)
    return tr.ids, tr.sizes


def _replay(pkg_egress, pkg_obs, ids, sizes, policy, capacity):
    store = pkg_egress.ObjectStore("gcs_internet")
    for i, n in enumerate(sizes):
        store.put(f"o{i}", bytes(int(n)))
    tracer, events = pkg_obs.Tracer(), pkg_obs.EventLog()
    store.set_tracer(tracer)
    cache = pkg_egress.EgressCache(store, capacity, policy, consumer="c",
                                   tracer=tracer, events=events)
    for i in ids:
        cache.get(f"o{int(i)}")
    return store, cache, tracer, events


@pytest.mark.parametrize("sizes", ["uniform", "variable"])
@pytest.mark.parametrize("policy", regress.ONLINE_POLICIES)
def test_egress_cache_replay_equal(policy, sizes):
    assert tegress.ONLINE_POLICIES == regress.ONLINE_POLICIES
    ids, obj_sizes = _trace(sizes)
    cap = float(np.sort(obj_sizes)[-12:].sum())
    rs, rc, rt, rev = _replay(regress, robs, ids, obj_sizes, policy, cap)
    ts, tc, tt, tev = _replay(tegress, tobs, ids, obj_sizes, policy, cap)
    assert ts.meter.snapshot() == rs.meter.snapshot()
    assert (tc.hits, tc.misses) == (rc.hits, rc.misses)
    assert tc.misses > 0 and tc.hits > 0
    assert dataclasses.asdict(tc.audit()) == dataclasses.asdict(rc.audit())
    assert tt.dollars(name="store.get") == rt.dollars(name="store.get")
    assert tev.snapshot() == rev.snapshot()


def _governed(pkg_egress, pkg_online, ids, sizes):
    store = pkg_egress.ObjectStore("s3_internet")
    for i, n in enumerate(sizes):
        store.put(f"o{i}", bytes(int(n)))
    metrics = pkg_online.MetricsRegistry()
    cache = pkg_egress.EgressCache(store, float(np.median(sizes) * 10),
                                   "lru", consumer="c", metrics=metrics)
    auditor = pkg_online.WindowedAuditor(cache.capacity, window=64,
                                         metrics=metrics)
    gov = pkg_online.DollarGovernor(cache, window=16, auditor=auditor,
                                    metrics=metrics)
    for i in ids:
        cache.get(f"o{int(i)}")
    win = gov.audit()
    return cache, gov, metrics, win


@pytest.mark.parametrize("sizes", ["uniform", "variable"])
def test_governed_replay_equal(sizes):
    ids, obj_sizes = _trace(sizes)
    rc, rg, rm, rw = _governed(regress, ronline, ids, obj_sizes)
    tc, tg, tm, tw = _governed(tegress, tonline, ids, obj_sizes)
    assert tg.snapshot() == rg.snapshot()
    assert [s.new_policy for s in tg.swaps] == [s.new_policy for s in rg.swaps]
    rw, tw = dataclasses.asdict(rw), dataclasses.asdict(tw)
    rw.pop("audit_seconds"), tw.pop("audit_seconds")   # wall time
    assert tw == rw
    rm, tm = rm.snapshot(), tm.snapshot()
    for snap in (rm, tm):                               # wall time
        snap["series"].pop("online.audit_seconds")
    assert tm == rm
    assert dataclasses.asdict(tc.audit()) == dataclasses.asdict(rc.audit())


def test_admission_and_schema_equal():
    store_r, store_t = (regress.ObjectStore("gcs_internet"),
                        tegress.ObjectStore("gcs_internet"))
    ar = ronline.SStarAdmission(store_r, 4000.0)
    at = tonline.SStarAdmission(store_t, 4000.0)
    for nbytes in (10, 333, 334, 10**6):
        for freq in (1, 2, 5):
            assert at.admit("k", nbytes, freq) == ar.admit("k", nbytes, freq)
    schema = {"type": "object", "required": ["a"],
              "properties": {"a": {"type": "integer", "minimum": 0}}}
    for doc in ({"a": 1}, {"a": -1}, {}, {"a": "x"}):
        assert tobs.validate(doc, schema) == robs.validate(doc, schema)
    assert tcore.PRICE_VECTORS.keys() == rcore.PRICE_VECTORS.keys()
