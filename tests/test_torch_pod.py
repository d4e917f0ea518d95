"""The port's pods (launch/pod.py, the clause-sharded engine stages, the
server's pod mode, plan_for) over 4 gloo ranks on the CPU, against the
JAX package on one device.

One ``torch.multiprocessing`` spawn of 4 ranks per module (``file://``
init under a temporary directory, so parallel test workers never share a
port) runs every case; each rank pickles its outputs, and the tests
compare them with the JAX package's single-device stages, which its own
tests (``tests/test_pod.py``) hold equal to its sharded ones.  The rank
code imports no JAX; the JAX side runs its ``ref`` backend here.
"""
import datetime
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import threefry
from repro_torch.core.dtm import FIELDS
from repro_torch.core.prng import PRNG
from repro_torch.launch import pod
from repro_torch.launch.mesh import make_clause_mesh, make_tenant_mesh
from repro_torch.launch.scheduler import (Backpressure, SchedulerConfig,
                                          SLAClass, TMScheduler)
from repro_torch.launch.serve_tm import TMServer, demo_batch, demo_specs

WORLD = 4
SPAWN_TIMEOUT_S = 300
KINDS = ("cotm", "vanilla", "conv", "regression", "head")
BATCH = 16
K_BANK = 4
# 8-row clause tiles: the roster's 24 clause rows pad to R = 24, so every
# rank's 6-row window holds real clauses (its TA streams keyed at row0)
TILE = dict(y=8, m=8)


def _labels(spec, batch):
    if spec.kind == "regression":
        return spec.encode_labels(np.linspace(0, 1, batch))
    return torch.as_tensor(np.arange(batch) % spec.classes,
                           dtype=torch.int32)


def _np(prog):
    from repro_torch import convert
    return convert.program_to_numpy(prog)


def _prng_np(prng):
    from repro_torch import convert
    return convert.prng_to_numpy(prng)


def spawn_ranks(fn, tmp, world=WORLD):
    """Run ``fn(rank, world, init_file, out_dir)`` on ``world`` spawned
    processes (gloo, a ``file://`` init under ``tmp``) and return each
    rank's pickled outputs.  Fails after ``SPAWN_TIMEOUT_S`` seconds,
    the ranks terminated."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, str(tmp / "init"), str(tmp)), nprocs=world,
        start_method="spawn", join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    outs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def init_gloo(rank, world, init_file):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def _route_tuple(r):
    return (r.device, r.slot, r.index, r.conv)


def _trace(specs, names, rounds=2):
    out = []
    for r in range(rounds):
        for i, name in enumerate(names):
            n = BATCH if (r + i) % 2 == 0 else BATCH // 2
            out.append((name, demo_batch(specs[name], n,
                                         seed=17 + 7 * r + i)))
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX here: the spawned processes import this module)
# ---------------------------------------------------------------------------

def _sharded_case(engine, specs, out):
    mesh = make_clause_mesh(device_type="cpu")
    for kind in KINDS:
        spec = specs[kind]
        conv = spec.kind == "conv"
        stm = pod.ShardedTM(engine, mesh, conv=conv)
        prog = engine.lower(spec, threefry.key(11, "cpu"))
        prng = PRNG.create(spec.tm_config(), 12, device="cpu")
        p = stm.shard(prog)
        rec = {"row0": engine._shard_window(p, stm.group).row0, "steps": []}
        for step in range(2):
            lits = engine.encode(spec, demo_batch(spec, BATCH, seed=3 + step))
            p, prng, stats = stm.train_step(p, prng, lits,
                                            _labels(spec, BATCH))
            rec["steps"].append({
                "prog": _np(stm.gather(p)), "prng": _prng_np(prng),
                "stats": {k: int(v) for k, v in stats.items()}})
        sums, cl = stm.infer(p, lits)
        rec["sums"], rec["cl"] = sums.numpy(), cl.numpy()
        rec["paths"] = dict(engine.cache_report()["path_per_stage"])
        rec["graphs"] = [(g["stage"], g["captured"], g["replays"])
                         for g in engine.graph_report()]
        rec["cache"] = {k: v for k, v in engine.cache_report().items()
                        if k != "path_per_stage"}
        out["sharded"][kind] = rec


def _bank_case(engine, specs, out):
    mesh = make_tenant_mesh(device_type="cpu")
    spec = specs["cotm"]
    progs = [engine.lower(spec, threefry.key(i, "cpu"))
             for i in range(K_BANK)]
    prngs = [PRNG.create(spec.tm_config(), 20 + i, device="cpu")
             for i in range(K_BANK)]
    lits = [engine.encode(spec, demo_batch(spec, BATCH, seed=i))
            for i in range(K_BANK)]
    labs = torch.stack([_labels(spec, BATCH)] * K_BANK)
    bank = pod.pod_stack(progs, engine, mesh, prngs=prngs)
    rec = {"local_k": bank.local.k}
    rec["infer"] = [t.numpy() for t in bank.infer(lits)]
    rec["infer_stacked"] = [t.numpy() for t in bank.infer(torch.stack(lits))]
    rec["predict"] = [t.numpy() for t in bank.predict(lits)]
    rec["train"] = {k: v.numpy() for k, v in bank.train(lits, labs).items()}
    rec["slots"] = [_np(p) for p in bank.unstack()]
    try:
        pod.pod_stack(progs[:3], engine, mesh)
        rec["k3"] = "no error"
    except ValueError as e:
        rec["k3"] = str(e)
    out["bank"] = rec


def _server_case(engine, specs, out):
    mesh = make_tenant_mesh(device_type="cpu")
    srv = TMServer(engine, batch_slot=BATCH, mesh=mesh)
    for name, spec in specs.items():
        srv.register(name, spec, seed=7)
    rec = {"routes": {n: _route_tuple(r)
                      for n, r in srv.routing_table().items()},
           "rounds": []}
    trips = []
    for name in specs:
        original = _np(srv.tenants[name].program)
        got = srv.swap_out(name)
        srv.swap_in(name, got)
        trips.append(all(np.array_equal(original[f], _np(got)[f])
                         and np.array_equal(_np(srv.swap_out(name))[f],
                                            original[f]) for f in FIELDS))
    rec["round_trips"] = trips
    for round_seed in (3, 5):
        for name, spec in specs.items():
            srv.enqueue(name, demo_batch(spec, BATCH, seed=round_seed))
        rec["rounds"].append(srv.flush())
        srv.train("cotm", demo_batch(specs["cotm"], BATCH),
                  np.zeros(BATCH, np.int32))
    rec["pod_devices"] = srv.stats()["pod_devices"]
    # pad-slot promotion: three flat residents pad to four slots; a
    # fourth tenant fills the pad in place
    flat = sorted(n for n in specs if specs[n].kind != "conv")
    srv.set_resident(flat[:3])
    for name in flat[:3]:
        srv.enqueue(name, demo_batch(specs[name], BATCH, seed=9))
    rec["before_promote"] = srv.flush()
    route = srv.add_resident(flat[3])
    rec["promoted"] = _route_tuple(route)
    for name in flat:
        srv.enqueue(name, demo_batch(specs[name], BATCH, seed=11))
    rec["after_promote"] = srv.flush()
    rec["promoted_slot"] = _np(srv.swap_out(flat[3]))
    out["server"] = rec

    # scheduled answers over a pod server equal the synchronous flush
    srv_ref = TMServer(engine, batch_slot=BATCH)
    srv_pod = TMServer(engine, batch_slot=BATCH, mesh=mesh)
    for name, spec in specs.items():
        srv_ref.register(name, spec, seed=2)
        srv_pod.register(name, spec, seed=2)
    sched = TMScheduler(srv_pod)
    trace = _trace(specs, sorted(specs))
    futs = [sched.submit(name, x) for name, x in trace]
    sched.drain()
    sync = []
    for name, x in trace:
        srv_ref.enqueue(name, x)
        sync.append(srv_ref.flush()[name])
    out["sched"] = {"scheduled": [f.result(timeout=5) for f in futs],
                    "sync": sync}


def _outcome(fut):
    exc = fut.exception(timeout=30)
    return "shed" if isinstance(exc, Backpressure) else fut.result()


def _pod_sched(engine, specs, mesh, cfg, sla=None):
    srv = TMServer(engine, batch_slot=BATCH, mesh=mesh)
    sched = TMScheduler(srv, config=cfg)
    for name, spec in specs.items():
        sched.register(name, spec, seed=2, sla=(sla or {}).get(name))
    return sched


def _sched_pod_case(engine, specs, rank, out):
    """The scheduler over the pod server where each rank's clock and
    submit times differ (rank r sleeps 2r ms after each submit): the
    formation window, EDF under a batch cap, the background loop, the
    membership ticks and admission are rank 0's decisions."""
    mesh = make_tenant_mesh(device_type="cpu")
    srv_ref = TMServer(engine, batch_slot=BATCH)
    for name, spec in specs.items():
        srv_ref.register(name, spec, seed=2)

    def sync(trace):
        res = []
        for name, x in trace:
            srv_ref.enqueue(name, x)
            res.append(srv_ref.flush()[name])
        return res

    def lag():
        time.sleep(0.002 * rank)

    rec = {}
    trace = _trace(specs, sorted(specs))
    rec["want"] = sync(trace)
    # step(force=False): a 2 ms window and 2 tenants a batch
    sched = _pod_sched(engine, specs, mesh, SchedulerConfig(
        max_wait_s=0.002, max_batch_tenants=2, pipeline_depth=2))
    futs = []
    for name, x in trace:
        futs.append(sched.submit(name, x))
        lag()
        sched.step(force=False)
    sched.drain()
    rec["window"] = [_outcome(f) for f in futs]
    rec["window_launches"] = sched.launches
    # the background loop, stopped right after the last submit
    sched = _pod_sched(engine, specs, mesh, SchedulerConfig())
    sched.start()
    futs = []
    for name, x in trace:
        futs.append(sched.submit(name, x))
        lag()
    sched.stop()
    rec["loop"] = [_outcome(f) for f in futs]
    # membership: two flat slots, a tick a cycle; "head" is hot
    mtrace = _trace(specs, ["head", "regression", "head", "cotm"])
    rec["want_members"] = sync(mtrace)
    sched = _pod_sched(engine, specs, mesh, SchedulerConfig(
        resident_slots=2, membership_every=1))
    futs = []
    for name, x in mtrace:
        futs.append(sched.submit(name, x))
        lag()
        sched.step(force=True)
    sched.drain()
    rec["members"] = [_outcome(f) for f in futs]
    rec["resident"] = sched.server.resident_names()
    rec["promotions"] = sched.promotions
    # admission: "cotm" holds one queued request, so rank 0 sheds the
    # second; the other ranks drop it when the third is batched
    sched = _pod_sched(engine, specs, mesh, SchedulerConfig(),
                       {"cotm": SLAClass("one", max_queue_depth=1)})
    xs = [demo_batch(specs["cotm"], BATCH, seed=40 + i) for i in range(3)]
    res = []
    for i, x in enumerate(xs):
        try:
            res.append(sched.submit("cotm", x))
        except Backpressure:
            res.append(None)
        lag()
        if i != 0:
            sched.drain()
    rec["shed"] = [None if f is None else _outcome(f) for f in res]
    rec["want_shed"] = sync([("cotm", x) for x in xs])
    out["sched_pod"] = rec


def _plan_case(specs, out):
    mesh = make_tenant_mesh(device_type="cpu")
    plan = api.plan_for(mesh, *specs.values(), **TILE)
    tight = api.plan_for(mesh, *specs.values(), **TILE,
                         vmem_budget=plan.program_bytes // 2)
    out["plan"] = {"wide": (plan.mode, plan.axis, plan.shards,
                            plan.program_bytes),
                   "tight": (tight.mode, tight.axis, tight.shards)}


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    init_gloo(rank, world, init_file)
    specs = demo_specs(small=True)
    engine = api.compile(api.tile_for(*specs.values(), **TILE), device="cpu")
    out = {"sharded": {}}
    _sharded_case(engine, specs, out)
    _bank_case(engine, specs, out)
    _server_case(engine, specs, out)
    _sched_pod_case(engine, specs, rank, out)
    _plan_case(specs, out)
    dist.destroy_process_group()
    if rank == 0:        # a world of one rank plans "single"
        init_gloo(0, 1, f"{init_file}1")
        plan = api.plan_for(make_tenant_mesh(device_type="cpu"),
                            *specs.values(), **TILE)
        out["plan"]["one"] = (plan.mode, plan.shards)
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(_rank_main, tmp_path_factory.mktemp("pod"))


# ---------------------------------------------------------------------------
# the JAX side (one device)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    from repro import api as japi
    from repro.launch.serve_tm import demo_specs as jdemo_specs
    specs = jdemo_specs(small=True)
    engine = japi.compile(japi.tile_for(*specs.values(), **TILE),
                          backend="ref")
    return specs, engine


def _jleaves(prog):
    return {f: np.asarray(getattr(prog, f)) for f in FIELDS}


def _assert_prog(got, want, what):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")


def _assert_answers(got, want, what=""):
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]),
                                      err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# (a) clause-sharded stages equal JAX's single-device stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_clause_sharded_equals_jax_single_device(ranks, jax_side, kind):
    """Two sharded train steps and an inference on 4 ranks against JAX's
    ``train_step``/``train_conv`` and ``infer``: every program leaf
    (gathered), the PRNG state, the stats, the sums and the clause
    matrix, on every rank."""
    import jax
    import jax.numpy as jnp
    from repro.core.prng import PRNG as JPRNG
    from test_torch_prng import jax_prng_numpy
    specs, engine = jax_side
    spec = specs[kind]
    conv = spec.kind == "conv"
    prog = engine.lower(spec, jax.random.PRNGKey(11))
    prng = JPRNG.create(spec.tm_config(), 12)
    step = engine.train_conv if conv else engine.train_step
    want = []
    for s in range(2):
        lits = engine.encode(spec, jnp.asarray(demo_batch(spec, BATCH,
                                                          seed=3 + s)))
        lab = (spec.encode_labels(np.linspace(0, 1, BATCH))
               if spec.kind == "regression" else
               jnp.asarray(np.arange(BATCH) % spec.classes, jnp.int32))
        prog, prng, stats = step(prog, prng, lits, lab)
        want.append((_jleaves(prog), jax_prng_numpy(prng),
                     {k: int(v) for k, v in stats.items()}))
    sums, cl = (engine.infer_conv if conv else engine.infer)(prog, lits)
    for r, out in enumerate(ranks):
        rec = out["sharded"][kind]
        assert rec["row0"] == r * (engine.R // WORLD)
        for s, (wp, wr, wst) in enumerate(want):
            got = rec["steps"][s]
            _assert_prog(got["prog"], wp, f"rank {r} step {s}")
            for k, v in wr.items():
                np.testing.assert_array_equal(np.asarray(got["prng"][k]),
                                              np.asarray(v), err_msg=k)
            assert got["stats"] == wst, (r, s)
        np.testing.assert_array_equal(rec["sums"], np.asarray(sums))
        np.testing.assert_array_equal(rec["cl"], np.asarray(cl))
        stage = "train_conv_sharded" if conv else "train_sharded"
        assert rec["paths"][stage + "_shard"] == f"clauses:{WORLD}"


@pytest.mark.parametrize("kind", KINDS)
def test_clause_sharded_stages_run_as_step_graphs(ranks, kind):
    """``ShardedTM`` runs each stage through one step graph a stage and
    shape: ``graph_report()`` lists the kind's infer and train stage with
    one graph each, not captured over gloo (its collectives cannot be),
    so the CPU runs the body the card replays; ``cache_report`` keeps
    JAX's engine stages only, all at 0 here."""
    conv = kind == "conv"
    suffix = "_conv_sharded" if conv else "_sharded"
    for out in ranks:
        rec = out["sharded"][kind]
        assert sorted(rec["graphs"]) == sorted(
            [("infer" + suffix, False, 0), ("train" + suffix, False, 0)])
        assert not any("sharded" in k for k in rec["cache"])
        assert all(v == 0 for v in rec["cache"].values())


# ---------------------------------------------------------------------------
# (b) PodBank equals JAX's single-device ProgramBank
# ---------------------------------------------------------------------------

def test_pod_bank_equals_jax_program_bank(ranks, jax_side):
    import jax
    import jax.numpy as jnp
    from repro import api as japi
    from repro.core.prng import PRNG as JPRNG
    specs, engine = jax_side
    spec = specs["cotm"]
    progs = [engine.lower(spec, jax.random.PRNGKey(i)) for i in range(K_BANK)]
    prngs = [JPRNG.create(spec.tm_config(), 20 + i) for i in range(K_BANK)]
    lits = jnp.stack([engine.encode(spec, jnp.asarray(
        demo_batch(spec, BATCH, seed=i))) for i in range(K_BANK)])
    labs = jnp.stack([jnp.asarray(np.arange(BATCH) % spec.classes,
                                  jnp.int32)] * K_BANK)
    bank = japi.stack(progs, engine, prngs=prngs)
    s_a, c_a = bank.infer(lits)
    pr_a, v_a = bank.predict(lits)
    st_a = bank.train(lits, labs)
    for out in ranks:
        rec = out["bank"]
        assert rec["local_k"] == K_BANK // WORLD
        for got in (rec["infer"], rec["infer_stacked"]):
            np.testing.assert_array_equal(got[0], np.asarray(s_a))
            np.testing.assert_array_equal(got[1], np.asarray(c_a))
        np.testing.assert_array_equal(rec["predict"][0], np.asarray(pr_a))
        np.testing.assert_array_equal(rec["predict"][1], np.asarray(v_a))
        for k, v in st_a.items():
            np.testing.assert_array_equal(rec["train"][k], np.asarray(v),
                                          err_msg=k)
        for k in range(K_BANK):
            _assert_prog(rec["slots"][k], _jleaves(bank.swap_out(k)),
                         f"slot {k}")


def test_pod_stack_needs_a_multiple_of_the_axis(ranks):
    for out in ranks:
        assert "multiple" in out["bank"]["k3"]


# ---------------------------------------------------------------------------
# (c) the server over a 4-rank mesh
# ---------------------------------------------------------------------------

def _jservers(engine, specs, seed):
    from repro.launch.serve_tm import TMServer as JServer
    srv = JServer(engine, batch_slot=BATCH)
    for name, spec in specs.items():
        srv.register(name, spec, seed=seed)
    return srv


def test_server_pod_flush_and_routes_equal_jax(ranks, jax_side):
    """Flushes around an on-line training step equal JAX's server on one
    device; the routes are JAX's ``routing_table`` of the padded roster;
    swaps round-trip."""
    from repro.launch import pod as jpod
    specs, engine = jax_side
    js = _jservers(engine, specs, 7)
    want = []
    for round_seed in (3, 5):
        for name, spec in specs.items():
            js.enqueue(name, demo_batch(spec, BATCH, seed=round_seed))
        want.append(js.flush())
        js.train("cotm", demo_batch(specs["cotm"], BATCH),
                 np.zeros(BATCH, np.int32))
    routes = {}
    for conv in (False, True):
        names = sorted(n for n in specs if (specs[n].kind == "conv") == conv)
        routes.update(jpod.routing_table(jpod.pad_roster(names, WORLD),
                                         WORLD, conv))
    for out in ranks:
        rec = out["server"]
        assert rec["pod_devices"] == WORLD
        for got, w in zip(rec["rounds"], want):
            _assert_answers(got, w)
        assert rec["routes"] == {n: _route_tuple(r)
                                 for n, r in routes.items()}
        assert {r[0] for n, r in rec["routes"].items() if not r[3]} == {
            0, 1, 2, 3}
        assert all(rec["round_trips"])


def test_server_pad_slot_promotion_equals_jax(ranks, jax_side):
    """Three flat residents pad to four slots; ``add_resident`` fills the
    pad in place (device 3, slot 0).  Answers and the promoted program
    equal JAX's one-device server doing the same (which restacks)."""
    specs, engine = jax_side
    js = _jservers(engine, specs, 7)
    for round_seed in (3, 5):     # the same history as the rank's server
        for name, spec in specs.items():
            js.enqueue(name, demo_batch(spec, BATCH, seed=round_seed))
        js.flush()
        js.train("cotm", demo_batch(specs["cotm"], BATCH),
                 np.zeros(BATCH, np.int32))
    flat = sorted(n for n in specs if specs[n].kind != "conv")
    js.set_resident(flat[:3])
    for name in flat[:3]:
        js.enqueue(name, demo_batch(specs[name], BATCH, seed=9))
    before = js.flush()
    js.add_resident(flat[3])
    for name in flat:
        js.enqueue(name, demo_batch(specs[name], BATCH, seed=11))
    after = js.flush()
    names, _ = js._bank_for(False)
    for out in ranks:
        rec = out["server"]
        _assert_answers(rec["before_promote"], before, "before")
        _assert_answers(rec["after_promote"], after, "after")
        assert rec["promoted"] == (3, 0, names.index(flat[3]), False)
        _assert_prog(rec["promoted_slot"], _jleaves(js.swap_out(flat[3])),
                     "promoted")


@pytest.mark.parametrize("devices", [1, 2, 3, 4])
def test_routing_functions_equal_jax(devices):
    from repro.launch import pod as jpod
    rng = np.random.default_rng(devices)
    for n in range(1, 10):
        names = [f"t{i}" for i in range(n)]
        rng.shuffle(names)
        padded = pod.pad_roster(names, devices)
        assert padded == jpod.pad_roster(names, devices)
        assert pod.first_pad_slot(padded) == jpod.first_pad_slot(padded)
        for conv in (False, True):
            got = pod.routing_table(padded, devices, conv)
            want = jpod.routing_table(padded, devices, conv)
            assert {k: _route_tuple(v) for k, v in got.items()} == {
                k: _route_tuple(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# (d) scheduled equals synchronous over the pod server
# ---------------------------------------------------------------------------

def test_scheduled_pod_equals_sync_flush_and_jax(ranks, jax_side):
    specs, engine = jax_side
    js = _jservers(engine, specs, 2)
    want = []
    for name, x in _trace(specs, sorted(specs)):
        js.enqueue(name, x)
        want.append(js.flush()[name])
    for out in ranks:
        rec = out["sched"]
        assert len(rec["scheduled"]) == len(want)
        for got, sync, w in zip(rec["scheduled"], rec["sync"], want):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(w))
            np.testing.assert_array_equal(np.asarray(sync), np.asarray(w))


def _same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mode", ["window", "loop", "members"])
def test_pod_scheduler_follows_rank_zero(ranks, mode):
    """Ranks whose submit times differ: ``step(force=False)`` under a
    formation window and a batch cap, the background loop, and the EWMA
    membership ticks give every rank the synchronous answers, and every
    rank the same roster."""
    for out in ranks:
        rec = out["sched_pod"]
        want = rec["want_members" if mode == "members" else "want"]
        _same_answers(rec[mode], want)
    if mode == "window":
        assert len({out["sched_pod"]["window_launches"]
                    for out in ranks}) == 1
    if mode == "members":
        assert ranks[0]["sched_pod"]["promotions"] > 0
        for out in ranks:
            assert out["sched_pod"]["resident"] == \
                ranks[0]["sched_pod"]["resident"]
            assert out["sched_pod"]["promotions"] == \
                ranks[0]["sched_pod"]["promotions"]


def test_pod_scheduler_admission_is_rank_zeros(ranks):
    """A request rank 0 sheds fails on every rank (raised there, its
    future elsewhere); the others are served."""
    for rank, out in enumerate(ranks):
        rec = out["sched_pod"]
        first, second, third = rec["shed"]
        assert (second is None) if rank == 0 else (second == "shed")
        _same_answers([first, third], [rec["want_shed"][0],
                                       rec["want_shed"][2]])


# ---------------------------------------------------------------------------
# (e) plan_for
# ---------------------------------------------------------------------------

def test_plan_for_equals_jax(ranks, jax_side):
    """``single`` on one rank, ``tenants`` on four; at half the program's
    bytes, ``clauses`` with JAX's shard count under the same budget (the
    JAX mesh a stand-in with its ``axis_names`` and ``devices.shape``)."""
    from repro import api as japi
    specs, _ = jax_side
    plans = ranks[0]["plan"]
    assert plans["one"] == ("single", 1)
    mode, axis, shards, pbytes = plans["wide"]
    assert (mode, axis, shards) == ("tenants", "tenants", WORLD)
    jmesh = types.SimpleNamespace(axis_names=("tenants",),
                                  devices=np.empty((WORLD,), object))
    want = japi.plan_for(jmesh, *specs.values(), **TILE,
                         vmem_budget=pbytes // 2)
    assert plans["tight"] == (want.mode, want.axis, want.shards)
    assert want.mode == "clauses"
    for out in ranks:
        assert out["plan"]["tight"] == plans["tight"]


def test_plan_for_h100_budget_keeps_small_rosters_tenant_parallel():
    from repro_torch.launch.mesh import H100
    specs = demo_specs(small=False)
    mesh = types.SimpleNamespace(mesh_dim_names=("tenants",), shape=(4,))
    plan = api.plan_for(mesh, *specs.values())
    assert plan.budget_bytes == H100.l2_bytes == 50 * 1024 * 1024
    assert plan.mode == "tenants"
    one = types.SimpleNamespace(mesh_dim_names=("tenants",), shape=(1,))
    assert api.plan_for(one, *specs.values()).mode == "single"


def test_mesh_constructors_need_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_tenant_mesh(device_type="cpu")
