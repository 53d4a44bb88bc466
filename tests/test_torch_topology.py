"""Live topology re-sharding in the port's FaaS runtime, held to the JAX
package (DESIGN.md §16).

The pure pieces equal JAX's on the same arguments: the consistent-hash
ring, the chunked assignment and its offset owner, the handover's move map
for a grow and a shrink, the ``--retune`` / ``--topology-tune`` parsing,
and every decision of ``TopologyTuner`` on the same measured steps. The
broker's handover ops are tested as JAX tests its own (``tests/
test_topology.py``): the fence mint is idempotent and replays from the
WAL, it is refused past the job's end, and a migration keeps every chunk
exactly once and is idempotent. Then real jobs with ``JOB`` and ``WCFG``
of ``test_torch_runtime.py`` (2 workers) at 30 steps, 10 an invocation,
paced by worker 0 sleeping 0.1 s a step (timing only; the math is the
same), so the supervisor reaches each trigger with steps left for the
fence: a live 1 -> 2 shard, tcp -> shm re-shard and back must end on the
fixed-topology job's bits, also with the source shard SIGKILLed in the
middle of the migration; an online ``topology_tune`` job must explore its
three cells, commit and keep the bits; and the retuned job must track
JAX's retuned job within the 1e-3 relative RMSE of
``test_live_job_tracks_the_jax_runtime``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import types
import warnings

import numpy as np
import pytest

from repro.core import autotuner as jautotuner
from repro.core.billing import CommModel as JCommModel
from repro.launch import train as jtrain
from repro.runtime import FaaSJobConfig as JFaaSJobConfig
from repro.runtime import run_job as jrun_job
from repro.runtime import sharding as jsharding
from repro.runtime import supervisor as jsupervisor

from repro_torch.core import autotuner
from repro_torch.core.billing import CommModel
from repro_torch.launch import train as train_cli
from repro_torch.runtime import protocol, sharding, supervisor
from repro_torch.runtime.broker import Broker
from repro_torch.runtime.supervisor import FaaSJobConfig, run_job

from test_torch_runtime import JOB, WCFG

STEPS = 30
PACE = {"worker": 0, "delay_s": 0.1, "every": 1}
RETUNES = ((3, {"n_brokers": 2, "transport": "shm"}),
           (9, {"n_brokers": 1, "transport": "tcp"}))
TOPO_JOB = dict(JOB, total_steps=STEPS, invocation_steps=10,
                wire_scheme="bitmap", deadline_s=240.0)


def _cfg(run_dir, **kw) -> FaaSJobConfig:
    return FaaSJobConfig(run_dir=str(run_dir), device="cpu",
                         workload_cfg=dict(WCFG), **dict(TOPO_JOB, **kw))


@contextlib.contextmanager
def _quiet():
    """A shard may own zero bytes at these sizes: ``tree_assignment``
    warns, in both packages alike, and the comparison does not care."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _tree(n_u: int, n_m: int) -> dict:
    return {"U": np.zeros((n_u, 4), np.float32),
            "M": np.zeros((n_m, 4), np.float32)}


# -- the pure functions against JAX -------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 7, 31])
def test_ring_assign_equals_jax(n_shards, seed):
    rng = np.random.RandomState(seed)
    keys = [f"leaf{seed}:{i}:{int(rng.randint(1_000_000))}"
            for i in range(64)]
    got = sharding.ring_assign(keys, n_shards)
    assert got == jsharding.ring_assign(keys, n_shards)
    assert got == sharding.ring_assign(list(reversed(keys)), n_shards)


@pytest.mark.parametrize("n_shards,split", [(1, 1024), (2, 1024),
                                            (3, 4096), (4, 2048)])
@pytest.mark.parametrize("shape", [(1000, 150), (4096, 33)])
def test_chunked_ring_assignment_and_owner_equal_jax(n_shards, split,
                                                     shape):
    tree = _tree(*shape)
    subs = sharding.tree_subleaves(tree, split)
    assert subs == jsharding.tree_subleaves(tree, split)
    with _quiet():
        got = sharding.tree_assignment(tree, n_shards, split_bytes=split,
                                       partitioner="ring")
        want = jsharding.tree_assignment(tree, n_shards, split_bytes=split,
                                         partitioner="ring")
    assert got == want
    assert set(got) == {sk for _, sk, _, _ in subs}
    owner = sharding.offset_owner(tree, split, got)
    jowner = jsharding.offset_owner(tree, split, want)
    for leaf_key, _sk, off, n in subs:
        for o in (off, off + n // 2, off + n - 1):
            assert owner(leaf_key, o) == jowner(leaf_key, o)


def _jax_move_map(params0, old: dict, new: dict):
    """JAX's move map, as ``repro/runtime/supervisor.py``'s
    ``_complete_handover`` computes it (:1116-1140)."""
    a_old = jsharding.tree_assignment(
        params0, int(old["n_brokers"]),
        split_bytes=int(old["shard_split_bytes"]),
        partitioner=old["partitioner"])
    a_new = jsharding.tree_assignment(
        params0, int(new["n_brokers"]),
        split_bytes=int(new["shard_split_bytes"]),
        partitioner=new["partitioner"])
    owner_new = jsharding.offset_owner(
        params0, int(new["shard_split_bytes"]), a_new)
    subleaves = jsharding.tree_subleaves(
        params0, int(old["shard_split_bytes"]))
    moves = {}
    for leaf_key, subkey, off, _n in subleaves:
        src, dest = a_old[subkey], owner_new(leaf_key, off)
        if src != dest:
            moves.setdefault((src, dest), []).append([leaf_key, off])
    return moves, len(subleaves)


@pytest.mark.parametrize("old_n,new_n,old_split,new_split,partitioner", [
    (1, 2, 65536, 65536, "ring"),     # grow
    (2, 1, 65536, 65536, "ring"),     # shrink
    (2, 4, 4096, 4096, "ring"),       # grow past two
    (3, 2, 4096, 8192, "ring"),       # shrink with a new chunk size
    (1, 3, 4096, 4096, "greedy"),     # grow under the greedy partitioner
])
def test_move_map_equals_jax(old_n, new_n, old_split, new_split,
                             partitioner):
    params0 = _tree(10681 // 8, 71567 // 8)
    old = {"n_brokers": old_n, "shard_split_bytes": old_split,
           "partitioner": partitioner}
    new = {"n_brokers": new_n, "shard_split_bytes": new_split,
           "partitioner": partitioner}
    sup = object.__new__(supervisor.Supervisor)
    sup.wl = types.SimpleNamespace(params0=params0)
    with _quiet():
        got = sup._move_map(old, new)
        want = _jax_move_map(params0, old, new)
    assert got == want
    moves, total = got
    assert sum(len(v) for v in moves.values()) <= total
    if partitioner == "ring" and old_split == new_split:
        # the ring moves keys only onto an added shard or off a removed one
        for src, dest in moves:
            assert (dest >= old_n) if new_n > old_n else (src >= new_n)


@pytest.mark.parametrize("argv", [
    [],
    ["--retune", '4:{"n_brokers": 2}'],
    ["--retune", '3:{"n_brokers": 2, "transport": "shm"}',
     "--retune", '7:{"n_brokers": 1, "transport": "tcp"}'],
    ["--topology-tune"],
    ["--topology-tune", "--shard-split-bytes", "4096"],
    ["--retune", '2:{"wire_scheme": "sparse"}', "--shard-split-bytes",
     "2048"],
])
def test_topology_args_equal_jax(argv):
    args = types.SimpleNamespace(retune=None, topology_tune=False,
                                 shard_split_bytes=0)
    it = iter(argv)
    for flag in it:
        if flag == "--retune":
            args.retune = (args.retune or []) + [next(it)]
        elif flag == "--topology-tune":
            args.topology_tune = True
        else:
            args.shard_split_bytes = int(next(it))
    assert train_cli._topology_args(args) == jtrain._topology_args(args)
    assert train_cli._parse_retunes(args.retune) == \
        jtrain._parse_retunes(args.retune)


@pytest.mark.parametrize("bad", ["4", "x:{}", '4:{"n_brokers": '])
def test_parse_retunes_refuses_as_jax(bad):
    for parse in (train_cli._parse_retunes, jtrain._parse_retunes):
        with pytest.raises(SystemExit, match="--retune"):
            parse([bad])


def _cells():
    return [{"n_brokers": 1, "transport": "tcp"},
            {"n_brokers": 2, "transport": "tcp"},
            {"n_brokers": 1, "transport": "shm"}]


def _drive(mod, comm, seed: int, cfg_kw: dict, scale: tuple) -> list:
    """Feed one seeded sequence of steps to a tuner, starting the next
    cell one straggling row after each explore action; returns every
    decision and the summary."""
    rng = np.random.RandomState(seed)
    tuner = mod.TopologyTuner(_cells(), mod.TopologyTunerConfig(**cfg_kw),
                              comm=comm, bytes_per_step=2e5, n_workers=4)
    out = []
    for _ in range(60):
        a = tuner.next_action()
        out.append(a)
        if a is not None and a[0] == "explore":
            tuner.observe(0.5)  # published between mint and handover
            tuner.cell_started()
        base = scale[tuner.active]
        tuner.observe(base * (1.0 + 0.1 * rng.rand()),
                      {"wire": base * rng.rand(), "compute": 0.01})
    out.append(tuner.summary())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw,scale", [
    ({"explore_steps": 3, "warmup_steps": 1}, (0.03, 0.02, 0.04)),
    ({"explore_steps": 6}, (0.03, 0.031, 0.0305)),  # a tie: the model
    ({"explore_steps": 2, "warmup_steps": 0, "rel_tolerance": 0.5},
     (0.02, 0.021, 0.019)),
])
def test_topology_tuner_decides_as_jax(seed, cfg_kw, scale):
    got = _drive(autotuner, CommModel(), seed, cfg_kw, scale)
    want = _drive(jautotuner, JCommModel(), seed, cfg_kw, scale)
    assert got == want
    summary = got[-1]
    assert summary["committed"] and not summary["abandoned"]
    assert [a[0] for a in got[:-1] if a is not None] == [
        "explore", "explore", "commit"]


def test_topology_tuner_model_tie_break_and_abandon_as_jax():
    """p50s within the tolerance: the cost model picks the cell with more
    shards; out of it the measurement wins; an abandoned tuner is quiet."""
    cells = _cells()[:2]
    for strict, want_n in ((0.5, 2), (0.01, 1)):
        picks = []
        for mod, comm in ((autotuner, CommModel()),
                          (jautotuner, JCommModel())):
            t = mod.TopologyTuner(
                cells, mod.TopologyTunerConfig(
                    explore_steps=2, warmup_steps=1, rel_tolerance=strict),
                comm=comm, bytes_per_step=1e6, n_workers=4)
            for _ in range(3):
                t.observe(0.0100)
            t.cell_started()
            for _ in range(3):
                t.observe(0.0105 if strict == 0.5 else 0.0150)
            picks.append((t.next_action(), t._model_cost(cells[0]),
                          t._model_cost(cells[1]), t.summary()))
        assert picks[0] == picks[1]
        assert picks[0][0] == ("commit", cells[want_n - 1])
    for mod in (autotuner, jautotuner):
        t = mod.TopologyTuner(cells, mod.TopologyTunerConfig(
            explore_steps=2, warmup_steps=1))
        for _ in range(3):
            t.observe(0.02)
        t.abandon()
        assert t.next_action() is None
        assert t.summary()["abandoned"] and t.summary()["chosen"] is None


# -- the broker's handover ops (JAX: tests/test_topology.py:328-404) ----------

BROKER_JOB = {"workload": "pmf", "workload_cfg": {}, "n_workers": 2,
              "total_steps": 10, "n_batches": 5}


class _Cluster:
    """In-thread port broker shards on ephemeral ports; shard 0 is the
    coordinator."""

    def __init__(self, job: dict, n_shards: int = 1, wal_dir=None):
        self.brokers = [
            Broker(dict(job), shard_id=s, n_shards=n_shards,
                   wal_path=(f"{wal_dir}/shard{s:02d}.wal" if wal_dir
                             else None))
            for s in range(n_shards)]
        self.addrs = [b.start() for b in self.brokers]

    @property
    def coordinator(self) -> Broker:
        return self.brokers[0]

    def rpc(self, header, payload=b"", shard=0):
        return protocol.request(self.addrs[shard], header, payload,
                                timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for b in self.brokers:
            assert b.stop(timeout=5.0) == []


def test_topo_begin_mint_idempotent_and_replayed(tmp_path):
    with _Cluster(BROKER_JOB, n_shards=2, wal_dir=str(tmp_path)) as c:
        r, _ = c.rpc({"t": "topo_begin"})
        assert r["granted"] and r["fence"] == 2  # max_published 0 -> 0 + 2
        r2, _ = c.rpc({"t": "topo_begin"})
        assert r2["granted"] and r2["fence"] == 2  # idempotent
        r3, _ = c.rpc({"t": "topo_begin"}, shard=1)
        assert not r3.get("granted")  # the coordinator alone mints
        hr, _ = c.rpc({"t": "hello", "worker": 0})
        assert hr["topo_fence"] == 2
    # a fresh cluster over the same WAL installs the minted fence (logged
    # as its result, never minted again)
    with _Cluster(BROKER_JOB, n_shards=2, wal_dir=str(tmp_path)) as c2:
        core = c2.coordinator.core
        assert core.topo_fence == 2
        r, _ = c2.rpc({"t": "topo_commit", "gen": 1, "n_shards": 2,
                       "n_brokers": 2, "transport": "shm"})
        assert r["ok"] and core.topo_fence is None and core.topo_gen == 1
        assert core.job["transport"] == "shm"
        hr, _ = c2.rpc({"t": "hello", "worker": 0})
        assert hr.get("topo_fence") is None
    with _Cluster(BROKER_JOB, n_shards=2, wal_dir=str(tmp_path)) as c3:
        assert c3.coordinator.core.topo_fence is None
        assert c3.coordinator.core.topo_gen == 1


def test_topo_begin_refuses_past_end():
    with _Cluster(dict(BROKER_JOB, total_steps=1)) as c:
        r, _ = c.rpc({"t": "topo_begin"})
        assert r["ok"] and not r["granted"] and r["reason"] == "past-end"
        assert c.coordinator.core.topo_fence is None


def test_migrate_roundtrip_totality_and_idempotence(tmp_path):
    """migrate_read -> migrate_in -> migrate_drop moves exactly the named
    (key, offset) identities; a retried migrate_in is a no-op; the byte
    meter follows the moved update; both sides replay from their WALs."""
    import torch

    meta, payload = protocol.encode_tree(
        {"x": torch.arange(6.0), "y": torch.ones(4)})
    pub = {"t": "publish", "worker": 0, "step": 1, "meta": meta,
           "loss": 1.0, "sent_fraction": 1.0, "inv_err": 0.0}
    with _Cluster(BROKER_JOB, n_shards=2, wal_dir=str(tmp_path)) as c:
        c.rpc(pub, payload)
        bytes_before = c.coordinator.core.update_bytes
        r, blob = c.rpc({"t": "migrate_read", "moved": [["x", 0]]})
        assert r["ok"] and r["parts"]
        r_in, _ = c.rpc({"t": "migrate_in", "gen": 1, "src": 0,
                         "parts": r["parts"]}, blob, shard=1)
        assert r_in["ok"] and not r_in.get("already")
        dup, _ = c.rpc({"t": "migrate_in", "gen": 1, "src": 0,
                        "parts": r["parts"]}, blob, shard=1)
        assert dup["ok"] and dup["already"]
        rd, _ = c.rpc({"t": "migrate_drop", "moved": [["x", 0]]})
        assert rd["ok"]
        assert [m["k"] for m in c.brokers[0].core.updates[1][0][0]] == ["y"]
        assert [m["k"] for m in c.brokers[1].core.updates[1][0][0]] == ["x"]
        moved = protocol.wire_bytes([m for m in meta if m["k"] == "x"])
        assert c.brokers[0].core.update_bytes == bytes_before - moved
        assert c.brokers[1].core.update_bytes == moved
    with _Cluster(BROKER_JOB, n_shards=2, wal_dir=str(tmp_path)) as c2:
        assert [m["k"] for m in c2.brokers[0].core.updates[1][0][0]] == ["y"]
        assert [m["k"] for m in c2.brokers[1].core.updates[1][0][0]] == ["x"]
        assert (1, 0) in c2.brokers[1].core.migrations_applied


# -- the config: refusals, JSON, the journal, the CLI -------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(consistency="ssp", slack=2, scripted_retunes=RETUNES[:1]), "isp"),
    (dict(consistency="ssp", slack=2, topology_tune=True), "isp"),
    (dict(prewarm=True, topology_tune=True), "prewarm"),
    (dict(prewarm=True, scripted_retunes=RETUNES[:1]), "prewarm"),
    (dict(scripted_retunes=((4, {"n_workers": 9}),)), "unknown knobs"),
])
def test_refusals_are_jax_s(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match) as got:
        supervisor.Supervisor(_cfg(tmp_path, **kw))
    with pytest.raises(ValueError, match=match) as want:
        jsupervisor.Supervisor(JFaaSJobConfig(
            run_dir=str(tmp_path), workload_cfg=dict(WCFG), **kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(scripted_retunes=RETUNES[:1]),
                                dict(topology_tune=True)])
def test_supervisor_kill_refused_with_live_resharding(tmp_path, kw):
    kill = {"seed": 1, "events": [{"kind": "supervisor_kill", "step": 3}]}
    with pytest.raises(ValueError, match="live re-sharding") as got:
        supervisor.Supervisor(_cfg(tmp_path, chaos=kill, **kw),
                              allow_self_kill=True)
    with pytest.raises(ValueError) as want:
        jsupervisor.Supervisor(JFaaSJobConfig(run_dir=str(tmp_path),
                                       workload_cfg=dict(WCFG), chaos=kill,
                                       **kw), allow_self_kill=True)
    assert str(got.value) == str(want.value)


def test_config_json_roundtrip_keeps_the_retunes(tmp_path):
    cfg = _cfg(tmp_path, scripted_retunes=RETUNES, partitioner="ring",
               shard_split_bytes=1024, kill_broker_during_handover=0,
               topo_explore_steps=3)
    back = FaaSJobConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg
    assert all(isinstance(s, int) and isinstance(c, dict)
               for s, c in back.scripted_retunes)
    # JAX's from_dict reads the same fields the same way
    jback = JFaaSJobConfig.from_dict(
        {k: v for k, v in json.loads(json.dumps(cfg.to_dict())).items()
         if k != "device"})
    assert jback.scripted_retunes == back.scripted_retunes


def test_journal_roundtrip_keeps_the_topology_and_held(tmp_path,
                                                       monkeypatch):
    cfg = _cfg(tmp_path / "job", scripted_retunes=RETUNES)
    sup = supervisor.Supervisor(cfg, resume=True)
    os.makedirs(cfg.run_dir)
    sup.topology = dict(sup.topology, n_brokers=2, transport="shm")
    sup.topo_gen = 2
    sup._max_brokers = 3
    sup.topology_events = [{"gen": 1, "fence": 5, "changes": {
        "n_brokers": 3}, "moved_subkeys": 2, "total_subkeys": 5}]
    sup.retired_shard_stats = [{"shard_id": 2, "dup_mismatches": 0,
                                "update_bytes": 123, "stats": {}}]
    sup.slots[1].held = True
    sup._save_journal()
    with open(os.path.join(cfg.run_dir, "supervisor.journal.json")) as f:
        st = json.load(f)
    # JAX's journal keys for the topology (repro/runtime/supervisor.py
    # :1419-1421, :1440, :1449-1450)
    for k in ("topology", "topo_gen", "max_brokers", "topology_events",
              "retired_shard_stats"):
        assert k in st
    assert [s["held"] for s in st["slots"]] == [False, True]
    back = supervisor.Supervisor(cfg, resume=True)
    monkeypatch.setattr(back, "_spawn_broker", lambda bs: None)
    assert back._resume_from_journal()
    assert back.topology == sup.topology and back.topo_gen == 2
    assert back._max_brokers == 3
    assert back.topology_events == sup.topology_events
    assert back.retired_shard_stats == sup.retired_shard_stats
    assert [s.held for s in back.slots] == [False, True]
    assert back.slots[1].adopted_pid is None  # a held slot has no process


def test_cli_takes_retune_and_topology_tune(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(supervisor, "run_job",
                        lambda cfg: seen.setdefault("cfg", cfg) and {})
    argv = ["train", "--runtime", "faas", "--device", "cpu", "--steps", "10",
            "--run-dir", str(tmp_path / "r")]
    monkeypatch.setattr(sys, "argv", argv + [
        "--retune", '3:{"n_brokers": 2, "transport": "shm"}',
        "--retune", '7:{"n_brokers": 1, "transport": "tcp"}'])
    train_cli.main()
    cfg = seen.pop("cfg")
    assert cfg.scripted_retunes == (
        (3, {"n_brokers": 2, "transport": "shm"}),
        (7, {"n_brokers": 1, "transport": "tcp"}))
    assert (cfg.partitioner, cfg.shard_split_bytes) == ("ring", 65536)
    assert not cfg.topology_tune
    monkeypatch.setattr(sys, "argv", argv + ["--topology-tune"])
    train_cli.main()
    cfg = seen.pop("cfg")
    assert cfg.topology_tune and cfg.scripted_retunes == ()
    assert (cfg.partitioner, cfg.shard_split_bytes) == ("ring", 65536)


# -- end to end on real processes ---------------------------------------------


@pytest.fixture(scope="module")
def fixed(tmp_path_factory):
    """The job at a fixed topology (one tcp shard, whole leaves)."""
    cfg = _cfg(tmp_path_factory.mktemp("fixed") / "job")
    res = run_job(cfg)
    return cfg, res, supervisor.final_params_digest(cfg)


def _retuned(run_dir, **kw) -> FaaSJobConfig:
    return _cfg(run_dir, scripted_retunes=RETUNES, partitioner="ring",
                shard_split_bytes=1024, straggler=PACE, **kw)


def _check_retuned(res, fixed_res) -> None:
    assert res["steps"] == STEPS and res["final_pool"] == 2
    assert res["dup_mismatches"] == 0 and res["invariant_max_err"] == 0.0
    events = res["topology_events"]
    assert [e["changes"] for e in events] == [c for _, c in RETUNES], events
    assert all("refused" not in e and not e.get("noop") for e in events)
    assert [e["gen"] for e in events] == [1, 2]
    for e in events:
        assert 3 <= e["fence"] <= STEPS
        assert 0 < e["moved_subkeys"] <= e["total_subkeys"] == 5
        # every worker parked with step fence-1 done and none ran past it:
        # no worker had begun the fence's step when it was minted
        assert e["at_frontier"] == e["fence"] - 1
    assert events[0]["fence"] < events[1]["fence"]
    assert res["topology"] == {"n_brokers": 1, "transport": "tcp",
                               "wire_scheme": "bitmap",
                               "shard_split_bytes": 1024,
                               "partitioner": "ring"}
    assert res["topology_gen"] == 2
    assert (res["n_brokers"], res["transport"]) == (1, "tcp")
    # billed at the peak shard count, not the final one
    assert res["bill"]["n_redis"] == 2
    assert res["respawns"] == []
    assert [r["wire_bytes"] for r in res["history"]] == [
        r["wire_bytes"] for r in fixed_res["history"]]
    assert [n for n in os.listdir("/dev/shm")
            if n.startswith(res["shm_token"])] == []


def test_live_reshard_is_bit_identical_to_the_fixed_topology(fixed,
                                                             tmp_path):
    """1 -> 2 shards with tcp -> shm, then back to one tcp shard: the
    final params equal the never-resharded job's bit for bit."""
    _, fixed_res, dig0 = fixed
    cfg = _retuned(tmp_path / "job")
    res = run_job(cfg)
    _check_retuned(res, fixed_res)
    # 2 workers: a first invocation and one after each handover (a
    # respawn's budget of 10 steps starts at its fence)
    assert res["n_invocations"] >= 2 * 3
    assert res["broker_respawns"] == []
    assert supervisor.final_params_digest(cfg) == dig0


def test_live_reshard_survives_a_shard_sigkill_mid_migration(fixed,
                                                             tmp_path):
    """The source shard SIGKILLed right after its first migrate_read: the
    retries ride its respawn and WAL replay, and the idempotent migrate
    ops land the same store."""
    _, fixed_res, dig0 = fixed
    cfg = _retuned(tmp_path / "job", kill_broker_during_handover=0)
    res = run_job(cfg)
    _check_retuned(res, fixed_res)
    assert len(res["broker_respawns"]) == 1
    assert res["broker_respawns"][0]["shard"] == 0
    assert supervisor.final_params_digest(cfg) == dig0


def test_online_topology_tune_explores_commits_and_keeps_the_bits(
        fixed, tmp_path):
    _, fixed_res, dig0 = fixed
    cfg = _cfg(tmp_path / "job", topology_tune=True, partitioner="ring",
               shard_split_bytes=1024, topo_explore_steps=2, straggler=PACE)
    res = run_job(cfg)
    tuner = res["topology_tuner"]
    assert tuner["committed"] and not tuner["abandoned"]
    cells = tuner["cells"]
    assert [(c["cell"]["n_brokers"], c["cell"]["transport"])
            for c in cells] == [(1, "tcp"), (2, "tcp"), (1, "shm")]
    assert all(c["n_steps"] >= 2 and c["p50"] > 0 for c in cells)
    assert res["topology"] == tuner["chosen_cell"]
    explores = [e for e in res["topology_events"] if not e.get("noop")]
    assert all("refused" not in e for e in res["topology_events"])
    assert all(e["at_frontier"] == e["fence"] - 1 for e in explores)
    assert [e["changes"] for e in explores[:2]] == [
        {"n_brokers": 2}, {"n_brokers": 1, "transport": "shm"}]
    assert res["dup_mismatches"] == 0 and res["steps"] == STEPS
    assert res["bill"]["n_redis"] == 2
    assert supervisor.final_params_digest(cfg) == dig0


def test_retuned_job_tracks_the_jax_runtime(tmp_path):
    """The port's retuned job against JAX's retuned job (the JAX package's
    own initial parameters, as ``test_live_job_tracks_the_jax_runtime``):
    final eval RMSE within 1e-3 relative, both re-sharded twice."""
    from test_torch_runtime import _params0

    kw = dict(scripted_retunes=RETUNES, partitioner="ring",
              shard_split_bytes=1024, straggler=PACE)
    cfg = FaaSJobConfig(run_dir=str(tmp_path / "port"), device="cpu",
                        workload_cfg=dict(WCFG, params0=_params0(tmp_path)),
                        **dict(TOPO_JOB, **kw))
    res = run_job(cfg)
    jres = jrun_job(JFaaSJobConfig(run_dir=str(tmp_path / "jax"),
                                   workload_cfg=dict(WCFG),
                                   **dict(TOPO_JOB, **kw)))
    rel = abs(res["final_eval"] - jres["final_eval"]) / jres["final_eval"]
    print(f"final eval port {res['final_eval']:.6f} jax "
          f"{jres['final_eval']:.6f} (rel {rel:.2e}); fences port "
          f"{[e['fence'] for e in res['topology_events']]} jax "
          f"{[e['fence'] for e in jres['topology_events']]}")
    for r in (res, jres):
        assert r["steps"] == STEPS and r["dup_mismatches"] == 0
        assert [e["changes"] for e in r["topology_events"]] == [
            c for _, c in RETUNES]
        assert r["topology_gen"] == 2 and r["bill"]["n_redis"] == 2
    assert np.isfinite(res["final_eval"]) and rel <= 1e-3
