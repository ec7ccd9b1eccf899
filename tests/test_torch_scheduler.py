"""Port's scheduling tier vs the reference's (mirrors tests/test_scheduler.py).

The solve-time estimator, the FIFO and deadline schedulers and admission
control are host-only copies: on the same admissions and clock they must
make the same decisions as the reference's. The service-level behaviors
that ride on them (rejection accounting, deadline misses, held ticks,
async dispatch against sync answers at rtol 1e-5 / atol 1e-6, the refresh
tick's foreground yield) run on the port's service on the CPU, with the
reference's service on the same queries where a counter is compared.
"""
import math

import numpy as np
import pytest

from repro.graph import generators as jgen
from repro.serve import DeadlineScheduler as JDeadline
from repro.serve import GraphRegistry as JRegistry
from repro.serve import PageRankService as JService
from repro.serve import PPRQuery as JQuery
from repro.serve import QueueEntry as JEntry
from repro.serve import SolveTimeEstimator as JEstimator
from repro.serve import TenantSpec as JTenant

from repro_torch.graph import generators
from repro_torch.serve import (AdmissionRejected, DeadlineScheduler,
                               FifoScheduler, GraphRegistry, PageRankService,
                               PPRQuery, QueueEntry, SolveTimeEstimator,
                               TenantSpec)
from _hypothesis_compat import given, settings, st


def entry(qid=0, graph="g", deadline=math.inf, tenant="default",
          priority=1, t0=0.0, c=0.85, tol=1e-4, cls=(PPRQuery, QueueEntry)):
    """A QueueEntry around a real PPRQuery (the scheduler never solves)."""
    qcls, ecls = cls
    q = qcls(qid=qid, graph=graph, seeds=(0,), c=c, tol=tol)
    return ecls(q=q, t0=t0, tr=None, deadline=deadline, tenant=tenant,
                priority=priority)


class TestSolveTimeEstimator:
    def test_fallback_chain_bucket_graph_global_default(self):
        est = SolveTimeEstimator(default_s=7.0)
        assert est.estimate("g", 4) == 7.0
        est.observe("g", 4, 2.0)
        assert est.estimate("g", 4) == 2.0
        assert est.estimate("g", 8) == 2.0
        assert est.estimate("other", 1) == 2.0

    def test_ewma_math(self):
        est = SolveTimeEstimator(alpha=0.25)
        est.observe("g", 4, 1.0)
        est.observe("g", 4, 2.0)
        assert est.estimate("g", 4) == pytest.approx(1.0 + 0.25 * (2.0 - 1.0))

    def test_exact_bucket_wins_over_fallbacks(self):
        est = SolveTimeEstimator(alpha=1.0)
        est.observe("g", 4, 0.1)
        est.observe("g", 16, 5.0)
        assert est.estimate("g", 4) == 0.1

    def test_reset_everything_or_one_graph(self):
        est = SolveTimeEstimator(default_s=0.0)
        est.observe("g", 4, 3.0)
        est.observe("h", 4, 1.0)
        est.reset(graph="g")
        assert set(est.snapshot()) == {("h", 4)}
        est.reset()
        assert est.estimate("g", 4) == 0.0 and est.snapshot() == {}

    def test_seed_is_replaced_by_the_first_sample(self):
        est = SolveTimeEstimator(alpha=0.25)
        est.seed("g", 9.0)
        assert est.estimate("g", 4) == 9.0
        est.observe("g", 4, 1.0)
        assert est.estimate("g", 8) == 1.0

    def test_alpha_validated(self):
        for alpha in (0.0, 1.5):
            with pytest.raises(ValueError):
                SolveTimeEstimator(alpha=alpha)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_same_estimates_as_reference(self, seed):
        rng = np.random.default_rng(seed)
        est, ref = SolveTimeEstimator(alpha=0.3), JEstimator(alpha=0.3)
        for _ in range(50):
            g, b = f"g{rng.integers(0, 3)}", int(2 ** rng.integers(0, 4))
            if rng.random() < 0.1:
                est.seed(g, 0.5)
                ref.seed(g, 0.5)
            s = float(rng.random())
            est.observe(g, b, s)
            ref.observe(g, b, s)
        assert est.snapshot() == ref.snapshot()
        for g in ("g0", "g1", "g2", "x"):
            for b in (1, 2, 4, 8, 16):
                assert est.estimate(g, b) == ref.estimate(g, b)


class TestFifoScheduler:
    def test_head_group_packed_in_arrival_order(self):
        s = FifoScheduler(max_batch=8)
        s.admit(entry(0, c=0.85))
        s.admit(entry(1, c=0.5))
        s.admit(entry(2, c=0.85))
        assert [e.q.qid for e in s.next_group(now=0.0)] == [0, 2]
        assert s.depth() == 1
        assert [e.q.qid for e in s.next_group(now=0.0)] == [1]

    def test_admission_bound(self):
        s = FifoScheduler(max_batch=8, max_depth=2)
        s.admit(entry(0))
        s.admit(entry(1))
        with pytest.raises(AdmissionRejected) as exc:
            s.admit(entry(2, tenant="t"))
        assert (exc.value.reason, exc.value.tenant, exc.value.depth) == \
            ("queue_full", "t", 2)


def dl_sched(max_batch=8, tenants=None, max_depth=None, margin=0.0,
             est=None, **kw):
    return DeadlineScheduler(
        max_batch, est if est is not None else SolveTimeEstimator(),
        tenants=tenants, max_depth=max_depth, slack_margin_s=margin, **kw)


class TestDeadlineAdmission:
    def test_per_tenant_bound_is_independent(self):
        s = dl_sched(tenants={"a": TenantSpec(name="a", max_depth=2)})
        s.admit(entry(0, tenant="a"))
        s.admit(entry(1, tenant="a"))
        with pytest.raises(AdmissionRejected) as exc:
            s.admit(entry(2, tenant="a"))
        assert (exc.value.reason, exc.value.tenant) == ("queue_full", "a")
        s.admit(entry(3, tenant="b"))
        assert s.depth_for("a") == 2 and s.depth_for("b") == 1

    def test_scheduler_wide_bound_is_the_fallback(self):
        s = dl_sched(max_depth=1)
        s.admit(entry(0, tenant="x"))
        with pytest.raises(AdmissionRejected):
            s.admit(entry(1, tenant="x"))
        s.admit(entry(2, tenant="y"))

    def test_depth_released_on_dispatch(self):
        s = dl_sched(max_depth=1)
        s.admit(entry(0, tenant="x", deadline=0.0))
        assert s.next_group(now=1.0) is not None
        assert s.depth_for("x") == 0
        s.admit(entry(1, tenant="x"))


class TestDeadlineRelease:
    def test_holds_while_slack_above_margin(self):
        s = dl_sched()
        s.admit(entry(0, deadline=10.0))
        assert s.next_group(now=0.0) is None
        assert [e.q.qid for e in s.next_group(now=10.0)] == [0]

    def test_margin_releases_early(self):
        s = dl_sched(margin=3.0)
        s.admit(entry(0, deadline=10.0))
        assert s.next_group(now=6.0) is None
        assert s.next_group(now=7.0) is not None

    def test_estimate_shifts_the_release_point(self):
        est = SolveTimeEstimator()
        est.observe("g", 1, 2.0)
        s = dl_sched(est=est)
        s.admit(entry(0, deadline=10.0))
        assert s.next_group(now=7.0) is None
        assert s.next_group(now=8.0) is not None

    def test_full_bucket_and_force_release(self):
        s = dl_sched(max_batch=2)
        s.admit(entry(0, deadline=math.inf))
        assert s.next_group(now=0.0) is None
        assert [e.q.qid for e in s.next_group(now=0.0, force=True)] == [0]
        s.admit(entry(1, deadline=math.inf))
        s.admit(entry(2, deadline=math.inf))
        assert len(s.next_group(now=0.0)) == 2

    def test_edf_priority_and_shared_batches(self):
        s = dl_sched()
        s.admit(entry(0, graph="slow", deadline=20.0))
        s.admit(entry(1, graph="fast", deadline=5.0))
        assert [e.q.qid for e in s.next_group(now=30.0)] == [1]
        s = dl_sched()
        s.admit(entry(0, deadline=9.0, priority=1, tenant="a"))
        s.admit(entry(1, deadline=5.0, priority=1, tenant="b"))
        s.admit(entry(2, deadline=5.0, priority=3, tenant="a"))
        assert [e.q.qid for e in s.next_group(now=10.0)] == [2, 1, 0]

    def test_min_slack_and_drain(self):
        est = SolveTimeEstimator()
        est.observe("g", 1, 1.0)
        s = dl_sched(est=est)
        assert s.min_slack(now=0.0) == math.inf
        s.admit(entry(0, deadline=10.0))
        s.admit(entry(1, graph="b", deadline=3.0))
        assert s.min_slack(now=1.0) == pytest.approx(1.0)
        assert [e.q.qid for e in s.drain()] == [1, 0]
        assert s.depth() == 0 and s.depth_for("default") == 0

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_same_decisions_as_reference(self, seed):
        """Random admissions, clock steps and releases: the port's
        scheduler admits, rejects, holds and releases exactly as the
        reference's does."""
        rng = np.random.default_rng(seed)
        tenants = {"hi": (3, 0.05, 4), "lo": (1, None, None)}
        ours = dl_sched(max_batch=4, max_depth=6, margin=0.01,
                        tenants={k: TenantSpec(k, p, math.inf if d is None
                                               else d, m)
                                 for k, (p, d, m) in tenants.items()},
                        bucket=lambda b: 1 << (b - 1).bit_length())
        est = JEstimator()
        ref = JDeadline(4, est, tenants={
            k: JTenant(k, p, math.inf if d is None else d, m)
            for k, (p, d, m) in tenants.items()}, max_depth=6,
            slack_margin_s=0.01, bucket=lambda b: 1 << (b - 1).bit_length())
        now = 0.0
        for qid in range(120):
            now += float(rng.exponential(0.01))
            if rng.random() < 0.6:
                tenant = ["hi", "lo", "other"][int(rng.integers(0, 3))]
                dl = now + float(rng.choice([0.02, 0.1, math.inf]))
                gname = f"g{rng.integers(0, 2)}"
                outcome = []
                for s, cls in ((ours, (PPRQuery, QueueEntry)),
                               (ref, (JQuery, JEntry))):
                    try:
                        s.admit(entry(qid, graph=gname, deadline=dl,
                                      tenant=tenant, t0=now, cls=cls))
                        outcome.append("ok")
                    except Exception as e:    # both must reject alike
                        outcome.append((type(e).__name__, e.reason))
                assert outcome[0] == outcome[1]
            else:
                force = bool(rng.random() < 0.2)
                a = ours.next_group(now, force=force)
                b = ref.next_group(now, force=force)
                assert (a is None) == (b is None)
                if a is not None:
                    assert [e.q.qid for e in a] == [e.q.qid for e in b]
                    t = float(rng.random() * 0.01)
                    ours.estimator.observe(a[0].q.graph, len(a), t)
                    est.observe(b[0].q.graph, len(b), t)
            assert ours.depth() == ref.depth()
            assert ours.min_slack(now) == ref.min_slack(now)


class TestNoStarvationProperty:
    @settings(max_examples=50, deadline=None)
    @given(st.lists(
        st.tuples(st.floats(0.0, 8.0, allow_nan=False),
                  st.floats(0.1, 5.0, allow_nan=False),
                  st.integers(0, 2)),
        min_size=1, max_size=30))
    def test_no_admitted_query_starved_past_deadline_plus_one_tick(
            self, arrivals):
        dt = 0.5
        s = dl_sched(max_batch=4)
        pending = sorted(((t, t + budget, f"g{gi}") for t, budget, gi
                          in arrivals), key=lambda e: e[0])
        deadlines, dispatched = {}, {}
        horizon = max(d for _, d, _ in pending) + 2 * dt
        qid, now = 0, 0.0
        while now <= horizon:
            while pending and pending[0][0] <= now:
                t, d, graph = pending.pop(0)
                s.admit(entry(qid, graph=graph, deadline=d, t0=t))
                deadlines[qid] = d
                qid += 1
            while True:
                group = s.next_group(now=now)
                if group is None:
                    break
                for e in group:
                    dispatched[e.q.qid] = now
            now += dt
        assert set(dispatched) == set(deadlines)
        for q, d in deadlines.items():
            assert dispatched[q] <= d + dt


# ---- service-level integration -------------------------------------------

def make_service(g, **kw):
    reg = GraphRegistry(update_mode=kw.pop("update_mode", "incremental"),
                        device="cpu")
    reg.register("g", g)
    defaults = dict(max_batch=8, cache_capacity=64, max_top_k=8)
    defaults.update(kw)
    return PageRankService(reg, **defaults)


class FakeClock:
    """A service clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestServiceScheduling:
    def test_rejection_stays_outside_the_disposition_invariant(self):
        svc = make_service(generators.tri_mesh(9, 11), admission_depth=1)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,)))
        with pytest.raises(AdmissionRejected):
            svc.submit(PPRQuery(qid=1, graph="g", seeds=(2,)))
        assert svc.stats["queries"] == 1
        assert svc.stats["rejected_queries"] == 1
        svc.run_until_drained()
        st_ = svc.stats
        assert st_["queries"] == (st_["cache_hits"] + st_["solved_queries"]
                                  + st_["dropped_queries"])

    def test_deadline_miss_counted_but_still_answered(self):
        svc = make_service(generators.tri_mesh(9, 11), scheduler="deadline")
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,), deadline_s=1e-9))
        assert 0 in svc.run_until_drained()
        assert svc.stats["deadline_misses"] == 1
        assert svc.stats["solved_queries"] == 1

    def test_generous_deadline_never_misses(self):
        svc = make_service(generators.tri_mesh(9, 11), scheduler="deadline",
                           default_deadline_s=60.0)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,)))
        svc.run_until_drained()
        assert svc.stats["deadline_misses"] == 0

    def test_held_ticks_counted(self):
        svc = make_service(generators.tri_mesh(9, 11), scheduler="deadline",
                           default_deadline_s=60.0)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,)))
        assert not svc.tick()
        assert svc.pending() == 1
        assert svc.stats["held_ticks"] == 1
        svc.run_until_drained()
        assert svc.stats["solved_queries"] == 1

    def test_estimator_times_dispatch_to_harvest_on_the_clock(self):
        clock = FakeClock()
        svc = make_service(generators.tri_mesh(9, 11), scheduler="deadline",
                           async_dispatch=True, clock=clock)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,)))
        svc.tick(force=True)                 # dispatched, in flight
        assert svc.pending() == 1 and not svc.estimator.snapshot()
        clock.t = 0.25
        svc.tick(force=True)                 # nothing new: harvests it
        assert svc.pending() == 0
        assert svc.estimator.snapshot() == {("g", 1): 0.25}

    def test_deadline_misses_read_the_clock_at_harvest(self):
        clock = FakeClock()
        svc = make_service(generators.tri_mesh(9, 11), scheduler="deadline",
                           async_dispatch=True, clock=clock)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,), deadline_s=0.1))
        svc.submit(PPRQuery(qid=1, graph="g", seeds=(2,), deadline_s=1.0,
                            c=0.5))
        clock.t = 0.05
        svc.tick(force=True)                 # qid 0's group dispatched
        clock.t = 0.5
        svc.tick(force=True)                 # qid 1 dispatched, 0 harvested
        svc.tick(force=True)                 # qid 1 harvested
        assert svc.stats["deadline_misses"] == 1
        assert svc.stats["solved_queries"] == 2

    @pytest.mark.parametrize("adaptive", [True, False])
    @pytest.mark.parametrize("scheduler", ["fifo", "deadline"])
    def test_async_dispatch_matches_sync_results(self, scheduler, adaptive):
        g = generators.tri_mesh(13, 17)
        rng = np.random.default_rng(3)
        queries = [tuple(int(s) for s in rng.choice(g.n, 2, replace=False))
                   for _ in range(6)]

        def answers(async_dispatch):
            svc = make_service(g, max_batch=4, cache_capacity=0,
                               scheduler=scheduler, adaptive=adaptive,
                               async_dispatch=async_dispatch,
                               default_deadline_s=60.0)
            for i, seeds in enumerate(queries):
                svc.submit(PPRQuery(qid=i, graph="g", seeds=seeds, top_k=5))
            return svc.run_until_drained(), svc.stats

        (sync, st_s), (awaited, st_a) = answers(False), answers(True)
        assert set(sync) == set(awaited)
        for qid in sync:
            np.testing.assert_array_equal(awaited[qid].indices,
                                          sync[qid].indices)
            np.testing.assert_allclose(awaited[qid].scores, sync[qid].scores,
                                       rtol=1e-5, atol=1e-6)
        assert st_a == st_s

    def test_async_stats_match_reference(self):
        gj, gt = jgen.tri_mesh(13, 17), generators.tri_mesh(13, 17)
        rng = np.random.default_rng(4)
        queries = [tuple(int(s) for s in rng.choice(gt.n, 2, replace=False))
                   for _ in range(10)] * 2
        reg_j = JRegistry()
        reg_j.register("g", gj)
        kw = dict(max_batch=4, cache_capacity=64, max_top_k=8,
                  scheduler="deadline", async_dispatch=True,
                  default_deadline_s=60.0)
        svc_j = JService(reg_j, **kw)
        svc_t = make_service(gt, **kw)
        for svc, qcls in ((svc_j, JQuery), (svc_t, PPRQuery)):
            for i, seeds in enumerate(queries):
                svc.submit(qcls(qid=i, graph="g", seeds=seeds, top_k=5))
                if i % 7 == 6:
                    svc.tick()
            svc.run_until_drained()
        st_j, st_t = svc_j.stats, svc_t.stats
        for key in st_t:
            if key != "deadline_misses":    # wall-clock dependent
                assert st_t[key] == st_j[key], key

    def test_update_flushes_the_inflight_batch_first(self):
        svc = make_service(generators.tri_mesh(9, 11), async_dispatch=True,
                           cache_capacity=0)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(1,)))
        svc.tick(force=True)
        assert svc.pending() == 1
        svc.update_graph("g", insert=[(0, 40)])
        assert svc.pending() == 0
        res = svc.run_until_drained()
        assert res[0].epoch == 0            # solved before the bump
        assert svc.registry.get("g").epoch == 1

    def test_refresh_tick_yields_to_foreground_load(self):
        svc = make_service(generators.tri_mesh(13, 17),
                           invalidation_radius=1, refresh_batch=4,
                           refresh_rounds=8)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(2,)))
        svc.run_until_drained()
        svc.update_graph("g", insert=[(0, 120)])
        assert len(svc._refresh) == 1
        svc.submit(PPRQuery(qid=1, graph="g", seeds=(40,)))
        assert svc.refresh_tick() == 0
        assert svc.stats["refresh_deferred"] == 1
        assert len(svc._refresh) == 1
        while svc.pending():
            svc.tick(force=True)
        assert svc.refresh_tick() == 1
        assert svc.stats["refreshes"] == 1

    def test_unknown_scheduler_and_instances(self):
        g = generators.tri_mesh(9, 11)
        with pytest.raises(ValueError, match="scheduler"):
            make_service(g, scheduler="lottery")
        fifo = FifoScheduler(max_batch=8)
        svc = make_service(g, scheduler=fifo)
        assert svc.scheduler is fifo and svc.policy == "fifo"
