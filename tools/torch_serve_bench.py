#!/usr/bin/env python3
"""Open-loop serving load generator of the PyTorch/CUDA port — the port of
``tools/serve_bench.py``: latency vs offered load, and the fleet's ramp.

Closed-loop clients (send, wait, send) hide queueing collapse — the
client slows down exactly when the server does, so the measured latency
stays flat while real users would be timing out.  This bench is
OPEN-loop: request arrival times are a Poisson process at the offered
rate, drawn up front and honored regardless of how the server is doing
(the "millions of users" model — arrivals don't care about your queue).

For each offered load it reports ONE JSON line::

    {"kind": "serve_bench", "offered_imgs_per_s": 400,
     "achieved_imgs_per_s": 398.2, "served": 1991, "shed": 0,
     "shed_rate": 0.0, "e2e_ms_p50": 3.1, "e2e_ms_p95": 4.9,
     "e2e_ms_p99": 6.2, "queue_ms_p50": ..., "device_ms_p50": ...}

sweeping ``--loads`` (imgs/s).  Run one load well past saturation to see
the load-shedding contract: shed_rate rises, the SERVED tail latency
stays bounded (the queue cannot grow past ``--max_queue``), and the
process stays healthy — instead of the unbounded-queue death spiral.

In-process by default (the port's ``ServeClient`` — no HTTP overhead,
measures the batcher+engine path the server wraps), on CUDA unless the
inherited ``--device cpu`` asks for the CPU.  CPU numbers are a
functional floor, never a device measurement.

Reduced-precision curves ride the inherited server flags: a sweep run
with ``--serve_dtype bf16`` and/or ``--quantize_int8`` measures the
bf16-bucket / int8-weight engine (the same ``build_engine`` path
the server uses) and RE-publishes the headline numbers under
precision-tagged keys (``bf16_imgs_per_sec``, ``int8_imgs_per_sec``,
``*_e2e_ms_p99``) plus a ``precision`` field — so an f32 baseline JSONL
and a reduced-precision run coexist in one ``tools/obs_diff.py`` gate
without the per-load keys colliding.

``--reload_every N`` (with ``--ckpt_dir``) hot-swaps the newest
checkpoint every N seconds DURING each load — the continuous-deployment
fleet's restore → build → canary → atomic-swap path under traffic —
and splits the served tail into swap-window vs steady-state percentiles.

``--adapt_every N`` (inherited server flag) runs the online
domain-adaptation loop DURING each load: the dispatcher feeds live
batches to the stat accumulator, and every N seconds an adapted
generation goes through the same canary → swap pipeline.  The record
splits the tail the same way (``adapt_swap_e2e_ms_p99`` vs
``adapt_steady_e2e_ms_p99``, same ``--swap_window_s``) and adds
``adapt_generations`` (canary-accepted folds this load) — the
adaptation-cadence-cost probe.  A
``DWT_FAULT_PLAN`` with ``serve_drift_shift`` / ``serve_poison_requests``
perturbs the generated traffic per request index, so one bench run can
drive the adapt-under-shift (or under-poison) scenario end to end.

``--ramp lo:hi:step_s --target_url URL`` drives a running fleet
(``python -m dwt_tpu_torch.fleet.balancer``) over HTTP instead and prints
one ``serve_ramp`` record (:func:`run_ramp`); ``--input_shape`` gives the
payload's image shape (``224,224,3`` for ResNet50-DWT).  Every request
body is encoded once, before the clock starts, and the arrival gaps are
drawn from ``np.random.default_rng(seed)`` as the JAX tool draws them, so
both give the same arrival times.

Run from the root of a checkout::

    python3 tools/torch_serve_bench.py --model lenet --init_random --loads 100,200
    python3 tools/torch_serve_bench.py --ramp 2:8:5 --target_url http://127.0.0.1:8979 \
        --input_shape 224,224,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

# Allow `python tools/serve_bench.py` from any cwd in a source checkout.
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _build_client(args):
    # One engine-construction path for the server AND the bench: the
    # bench must measure exactly the engine the server would run.
    from dwt_tpu_torch.serve.server import ServeClient, build_engine

    engine = build_engine(args)
    client = ServeClient(
        engine,
        max_batch_delay_ms=args.max_batch_delay_ms,
        max_queue_items=args.max_queue,
    )
    return client, engine.input_shape


def _apply_spike(gaps) -> None:
    """Fold an armed ``traffic_spike`` fault into the Poisson gaps.

    A spike is a STEP in the offered rate, not a burst of extra
    requests: from ``at_request`` onward every inter-arrival gap is
    divided by ``factor`` (rate × factor) before the cumsum, so the
    arrival process stays Poisson — just faster — and the request count
    is unchanged (the open-loop contract still decides what sheds).
    No-op when no plan is armed.
    """
    from dwt_tpu_torch.resilience import inject

    spike = inject.traffic_spike()
    if not spike:
        return
    at = min(int(spike["at_request"]), len(gaps))
    gaps[at:] /= float(spike["factor"])


def run_load(client, input_shape, offered: float, seconds: float,
             request_n: int, seed: int = 0,
             reloader=None, reload_every_s: float = 0.0,
             swap_window_s: float = 0.5, adapter=None) -> dict:
    """One open-loop measurement at ``offered`` imgs/s for ``seconds``.

    Arrivals are Poisson (exponential gaps) in REQUEST units
    (``offered / request_n`` requests/s); each request is ``request_n``
    images of noise (serving cost is shape-, not content-, dependent).
    Shed requests are counted, not retried — the open-loop contract.

    ``reloader`` + ``reload_every_s``: a hot-swap thread force-redeploys
    the newest checkpoint every ``reload_every_s`` seconds DURING the
    load (a same-checkpoint swap — numerically a no-op, operationally
    the full restore → build → swap path).  The record then splits the
    latency tail into ``swap_*`` (requests resolved within
    ``swap_window_s`` after a swap, sliced on the access log's
    resolution stamps) vs ``steady_*`` — the swap-cost-under-load probe.

    ``adapter``: a started :class:`~dwt_tpu_torch.serve.adapt.DomainAdapter`
    already attached to ``client``.  Its swaps are detected by polling
    the accepted-generation counter (the adapter runs on its own
    cadence thread; the bench only observes), timestamped on the same
    resolution-stamp timebase, and split into ``adapt_swap_*`` vs
    ``adapt_steady_*`` with the same window.
    """
    from dwt_tpu_torch.resilience import inject
    from dwt_tpu_torch.serve.batcher import ShedError

    rng = np.random.default_rng(seed)
    req_rate = offered / request_n
    n_requests = max(1, int(round(req_rate * seconds)))
    gaps = rng.exponential(1.0 / req_rate, size=n_requests)
    _apply_spike(gaps)
    arrivals = np.cumsum(gaps)
    x = rng.normal(size=(request_n,) + tuple(input_shape)).astype(np.float32)

    shed, errors = 0, 0
    futures = []
    # Per-request latencies come from the ACCESS LOG (stamped at
    # resolution time by the dispatcher, before the future resolves),
    # not from harvest-time arithmetic — a request that resolved seconds
    # before its future is read must not book those idle seconds as
    # latency.  Count-diffed windows isolate THIS load point's samples
    # from earlier sweep points and the warmup.
    before = client.access_log.windows()
    done = threading.Event()
    swap_ts = []  # resolution-stamp timebase (seconds since log t0)

    def _swap_loop():
        while not done.wait(reload_every_s):
            try:
                # Stamp AFTER the deploy returns: the restore/build runs
                # concurrently with serving (its contention shows in the
                # overall tail); the swap window measures the pointer
                # flip's own impact on in-flight traffic.
                if reloader.reload_newest(force=True):
                    swap_ts.append(
                        time.perf_counter() - client.access_log.t0
                    )
            except Exception as e:  # keep the bench honest, not dead
                print(f"serve_bench: swap failed: {e}", file=sys.stderr)

    adapt_ts = []  # adapted-swap stamps, same timebase as swap_ts
    gen0 = adapter.generation if adapter is not None else 0

    def _adapt_watch():
        # Observe, don't drive: the adapter folds on its own thread; a
        # 50 ms poll of the accepted-generation counter timestamps each
        # swap well inside the 0.5 s attribution window.
        seen = gen0
        while not done.wait(0.05):
            gen = adapter.generation
            if gen > seen:
                adapt_ts.extend(
                    [time.perf_counter() - client.access_log.t0]
                    * (gen - seen)
                )
                seen = gen

    def _submit_all():
        nonlocal shed
        t0 = time.perf_counter()
        for i, t_arr in enumerate(arrivals):
            delay = t0 + t_arr - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            # Armed DWT_FAULT_PLAN serving kinds perturb the open-loop
            # traffic itself (no-ops when disarmed): drift first — the
            # world moved — then poison rides the drifted stream.
            xi = inject.maybe_shift_request(i, x)
            xi = inject.maybe_poison_request(i, xi)
            try:
                futures.append(client.submit(xi))
            except ShedError:
                shed += 1

    submitter = threading.Thread(target=_submit_all, daemon=True)
    swapper = None
    if reloader is not None and reload_every_s > 0:
        swapper = threading.Thread(target=_swap_loop, daemon=True)
    watcher = None
    if adapter is not None:
        watcher = threading.Thread(target=_adapt_watch, daemon=True)
        watcher.start()
    t_start = time.perf_counter()
    submitter.start()
    if swapper is not None:
        swapper.start()
    submitter.join()
    # Harvest: every accepted request must resolve (bounded queue + the
    # dispatcher draining it guarantee this terminates promptly).
    for fut in futures:
        try:
            fut.result(timeout=60.0)
        except Exception:
            errors += 1
    # Clock stops when the last request resolves — BEFORE joining the
    # swapper, whose tail reload would otherwise inflate duration_s (and
    # deflate achieved rate) in exactly the reloading arm of the A/B.
    elapsed = time.perf_counter() - t_start
    done.set()
    if swapper is not None:
        swapper.join(timeout=60.0)
    if watcher is not None:
        watcher.join(timeout=60.0)
    after = client.access_log.windows()
    delta = after["served_requests"] - before["served_requests"]

    from dwt_tpu_torch.utils.metrics import percentile_summary

    served = len(futures) - errors
    total = served + shed + errors
    record = {
        "kind": "serve_bench",
        "offered_imgs_per_s": round(offered, 1),
        "duration_s": round(elapsed, 3),
        "request_n": request_n,
        "requests": total,
        "served": served,
        "shed": shed,
        "errors": errors,
        "shed_rate": round(shed / max(total, 1), 4),
        "achieved_imgs_per_s": round(
            served * request_n / max(elapsed, 1e-9), 1
        ),
    }
    for name, qs in (("e2e_ms", (50.0, 95.0, 99.0)),
                     ("queue_ms", (50.0, 99.0)),
                     ("device_ms", (50.0, 99.0))):
        window = after[name][-delta:] if delta > 0 else []
        record.update(percentile_summary(window, qs, prefix=f"{name}_p"))
    if swapper is not None:
        e2e = after["e2e_ms"][-delta:] if delta > 0 else []
        tstamps = after["resolved_t"][-delta:] if delta > 0 else []
        in_swap = [
            v for v, t in zip(e2e, tstamps)
            if any(ts <= t <= ts + swap_window_s for ts in swap_ts)
        ]
        steady = [
            v for v, t in zip(e2e, tstamps)
            if not any(ts <= t <= ts + swap_window_s for ts in swap_ts)
        ]
        record.update(
            swaps=len(swap_ts),
            swap_window_s=swap_window_s,
            swap_requests=len(in_swap),
            **percentile_summary(in_swap, (50.0, 99.0),
                                 prefix="swap_e2e_ms_p"),
            **percentile_summary(steady, (50.0, 99.0),
                                 prefix="steady_e2e_ms_p"),
        )
    if adapter is not None:
        e2e = after["e2e_ms"][-delta:] if delta > 0 else []
        tstamps = after["resolved_t"][-delta:] if delta > 0 else []
        in_adapt = [
            v for v, t in zip(e2e, tstamps)
            if any(ts <= t <= ts + swap_window_s for ts in adapt_ts)
        ]
        adapt_steady = [
            v for v, t in zip(e2e, tstamps)
            if not any(ts <= t <= ts + swap_window_s for ts in adapt_ts)
        ]
        record.update(
            adapt_generations=adapter.generation - gen0,
            adapt_swaps=len(adapt_ts),
            adapt_swap_window_s=swap_window_s,
            adapt_swap_requests=len(in_adapt),
            adapt_fold_attempts=adapter.fold_attempts,
            **percentile_summary(in_adapt, (50.0, 99.0),
                                 prefix="adapt_swap_e2e_ms_p"),
            **percentile_summary(adapt_steady, (50.0, 99.0),
                                 prefix="adapt_steady_e2e_ms_p"),
        )
    return record


def _parse_ramp(spec: str):
    """``lo:hi:step_s`` → (lo, hi, step_s), strictly validated."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(f"--ramp wants lo:hi:step_s, got {spec!r}")
    lo, hi, step_s = (float(v) for v in parts)
    if not (lo > 0 and hi >= lo and step_s > 0):
        raise ValueError(
            f"--ramp needs 0 < lo <= hi and step_s > 0, got {spec!r}"
        )
    return lo, hi, step_s


def _ramp_schedule(lo: float, hi: float):
    """Geometric (doubling) rate steps lo → hi, hi always included."""
    rates, r = [], lo
    while r < hi:
        rates.append(r)
        r *= 2.0
    rates.append(hi)
    return rates


def run_ramp(args) -> dict:
    """Open-loop HTTP ramp against a live fleet's front door.

    The sweep arm measures the engine in-process; this arm measures the
    FLEET — the balancer, its weighted routing, and the autoscaler's
    reaction time are the objects under test, so requests go over real
    HTTP and the fleet's own ``/healthz`` is polled for the first
    ``target_replicas`` increase.  The offered rate steps geometrically
    ``lo → hi`` (each level held ``step_s``), arrivals Poisson within
    each level and honored regardless of how the fleet is doing.

    One ``serve_ramp`` record: ``ramp_scale_lag_s`` (ramp start → first
    observed scale-up), ``ramp_shed_total`` (429/503 answers),
    ``ramp_lost_total`` (no HTTP answer at all — the loss-free contract
    says this stays 0 even while replicas retire), overall and
    post-scale-up served tails, and ``ramp_fast_share`` (largest
    per-replica share of served requests, off the balancer's
    ``X-DWT-Replica`` stamp — the weighted-routing probe).
    """
    import http.client
    import queue
    import urllib.parse

    url = args.target_url
    if "//" not in url:
        url = "http://" + url
    parsed = urllib.parse.urlsplit(url)
    host, port = parsed.hostname, parsed.port or 80

    input_shape = tuple(
        int(v) for v in str(args.input_shape).split(",") if v.strip()
    )
    lo, hi, step_s = _parse_ramp(args.ramp)
    rates = _ramp_schedule(lo, hi)
    rng = np.random.default_rng(args.seed)
    x = rng.normal(
        size=(args.request_n,) + input_shape
    ).astype(np.float32)
    body = json.dumps({"inputs": x.tolist()}).encode()

    results = []  # (t_submit_rel, e2e_ms|None, status|None, rid|None)
    results_lock = threading.Lock()
    jobs: "queue.Queue" = queue.Queue()
    done = threading.Event()
    t0 = time.perf_counter()

    def _worker():
        conn = None
        while True:
            job = jobs.get()
            if job is None:
                return
            t_due = job
            t_send = time.perf_counter()
            status, rid, e2e_ms = None, None, None
            try:
                if conn is None:
                    conn = http.client.HTTPConnection(
                        host, port, timeout=30.0
                    )
                conn.request("POST", "/infer", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                status = resp.status
                rid = resp.getheader("X-DWT-Replica")
                e2e_ms = (time.perf_counter() - t_send) * 1e3
            except Exception:
                # A dead kept-alive conn or a mid-request failure: the
                # request got NO answer — that is exactly what
                # ramp_lost_total counts.  Fresh conn for the next one.
                try:
                    if conn is not None:
                        conn.close()
                except Exception:
                    pass
                conn = None
            with results_lock:
                results.append((t_due - t0, e2e_ms, status, rid))

    # Time-to-first-scale-up watcher: the fleet's own target_replicas
    # gauge (via /healthz) is the autoscaler's decision stamp.
    baseline_target = None
    scale_up_t = [None]

    def _watch():
        nonlocal baseline_target
        while not done.wait(0.1):
            try:
                conn = http.client.HTTPConnection(host, port, timeout=2.0)
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                h = json.loads(resp.read() or b"{}")
                conn.close()
            except Exception:
                continue
            tgt = h.get("target_replicas")
            if tgt is None:
                continue
            if baseline_target is None:
                baseline_target = tgt
            elif tgt > baseline_target and scale_up_t[0] is None:
                scale_up_t[0] = time.perf_counter() - t0

    workers = [
        threading.Thread(target=_worker, daemon=True)
        for _ in range(args.ramp_workers)
    ]
    for w in workers:
        w.start()
    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()

    n_sent = 0
    for rate in rates:
        req_rate = rate / args.request_n
        n = max(1, int(round(req_rate * step_s)))
        gaps = np.random.default_rng(args.seed + n_sent).exponential(
            1.0 / req_rate, size=n
        )
        t_level = time.perf_counter()
        for t_arr in np.cumsum(gaps):
            delay = t_level + t_arr - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            jobs.put(time.perf_counter())
            n_sent += 1
    for _ in workers:
        jobs.put(None)
    for w in workers:
        w.join(timeout=120.0)
    done.set()
    watcher.join(timeout=10.0)

    from dwt_tpu_torch.utils.metrics import percentile_summary

    served = [(t, ms, rid) for t, ms, s, rid in results if s == 200]
    shed = sum(1 for _, _, s, _ in results if s in (429, 503))
    lost = sum(1 for _, _, s, _ in results if s is None)
    per_replica = {}
    for _, _, rid in served:
        per_replica[str(rid)] = per_replica.get(str(rid), 0) + 1
    record = {
        "kind": "serve_ramp",
        "ramp": args.ramp,
        "ramp_rates_imgs_per_s": [round(r, 1) for r in rates],
        "requests": len(results),
        "served": len(served),
        "ramp_shed_total": shed,
        "ramp_lost_total": lost,
        "replica_requests": per_replica,
        **percentile_summary([ms for _, ms, _ in served], (50.0, 99.0),
                             prefix="ramp_e2e_ms_p"),
    }
    if per_replica and len(served) > 0:
        record["ramp_fast_share"] = round(
            max(per_replica.values()) / len(served), 4
        )
    if scale_up_t[0] is not None:
        record["ramp_scale_lag_s"] = round(scale_up_t[0], 2)
        # "Post-scale steady state": requests submitted once the new
        # replica had ~1 s to come up — did adding capacity actually
        # pull the tail back down?
        settle = scale_up_t[0] + 1.0
        record.update(percentile_summary(
            [ms for t, ms, _ in served if t >= settle], (99.0,),
            prefix="ramp_post_scale_e2e_ms_p",
        ))
    return record


def main(argv=None) -> int:
    from dwt_tpu_torch.serve.server import build_parser, build_plan

    p = argparse.ArgumentParser(
        description="open-loop (Poisson) serving load sweep",
        parents=[build_parser()], conflict_handler="resolve", add_help=True,
    )
    p.add_argument("--loads", default="100,200,400,800",
                   help="comma-separated offered loads (imgs/s) to sweep")
    p.add_argument("--duration_s", type=float, default=5.0,
                   help="measurement window per offered load")
    p.add_argument("--request_n", type=int, default=1,
                   help="images per request")
    p.add_argument("--warmup_requests", type=int, default=8,
                   help="requests served before timing starts")
    p.add_argument("--reload_every", type=float, default=0.0,
                   help="hot-swap the newest --ckpt_dir checkpoint every "
                        "N seconds DURING each load (same-checkpoint "
                        "swap: the numeric no-op / swap-cost probe); the "
                        "record adds swap-window vs steady-state p99")
    p.add_argument("--swap_window_s", type=float, default=0.5,
                   help="window after each swap attributed to it in the "
                        "swap-vs-steady latency split")
    p.add_argument("--ramp", default="",
                   help="lo:hi:step_s — open-loop HTTP ramp against a "
                        "live fleet's front door (--target_url): rate "
                        "doubles lo→hi, each level held step_s; emits "
                        "one serve_ramp record with scale-lag / shed / "
                        "lost / per-replica share (the autoscaler + "
                        "weighted-routing probe)")
    p.add_argument("--target_url", default="",
                   help="fleet front-door URL for --ramp "
                        "(e.g. http://127.0.0.1:8100)")
    p.add_argument("--ramp_workers", type=int, default=32,
                   help="HTTP worker threads for --ramp (each keeps a "
                        "persistent connection)")
    p.add_argument("--input_shape", default="28,28,1",
                   help="input image shape for --ramp payloads (ramp "
                        "mode drives a remote fleet, no local engine)")
    args = p.parse_args(argv)
    if args.reload_every > 0 and not args.ckpt_dir:
        p.error("--reload_every needs --ckpt_dir (the watched directory)")
    if args.ramp:
        if not args.target_url:
            p.error("--ramp needs --target_url (the fleet front door)")
        try:
            _parse_ramp(args.ramp)
        except ValueError as e:
            p.error(str(e))
        print(json.dumps(run_ramp(args)), flush=True)
        return 0

    if build_plan(args).mode != "single":
        p.error("the bench drives one in-process engine: serve the fan-out over "
                "ranks with the server and drive it with --ramp --target_url")
    # Inherited --obs_trace (server parser): every bench run can emit a
    # bucket-attributed serving trace for tools/torch_obs_report.py.
    from dwt_tpu_torch import obs

    obs.maybe_enable(args.obs_trace)
    client, input_shape = _build_client(args)
    reloader = None
    if args.reload_every > 0:
        # The swap path under test is the real one: restore → adapt →
        # cache factorization → plan placement → canary → atomic swap.
        from dwt_tpu_torch.fleet import CanaryGate, HotReloader

        canary_x = np.random.default_rng(args.seed).normal(
            size=(min(8, client.engine.buckets[-1]),) + tuple(input_shape)
        ).astype(np.float32)
        reloader = HotReloader(
            client.engine, args.ckpt_dir,
            access_log=client.access_log,
            canary=CanaryGate(client.engine, canary_x),
        )
    adapter = None
    from dwt_tpu_torch.serve.server import adapt_enabled

    if adapt_enabled(args):
        # The real serve-side adaptation loop: dispatcher hook → stat
        # accumulator → canary → swap, on its own cadence thread.  The
        # bench measures what serving pays for it, per load point.
        from dwt_tpu_torch.serve.server import (
            build_adapter, build_deploy_controller,
        )

        controller = build_deploy_controller(
            args, client.engine, client.access_log
        )
        adapter = build_adapter(
            args, client.engine, client.access_log, controller=controller
        )
        client.attach_adapter(adapter)
        adapter.start()
    rng = np.random.default_rng(args.seed)
    warm = rng.normal(
        size=(args.request_n,) + tuple(input_shape)
    ).astype(np.float32)
    for _ in range(args.warmup_requests):
        client.infer(warm)

    # Precision tags for the reduced-precision curves: both can be set at
    # once (int8 weights + bf16 model).
    from dwt_tpu_torch.serve.server import resolve_serve_dtype

    tags = []
    if getattr(args, "quantize_int8", False):
        tags.append("int8")
    if resolve_serve_dtype(args) == "bf16":
        tags.append("bf16")

    rc = 0
    try:
        for offered in (float(v) for v in args.loads.split(",")):
            record = run_load(
                client, input_shape, offered, args.duration_s,
                args.request_n, seed=args.seed,
                reloader=reloader, reload_every_s=args.reload_every,
                swap_window_s=args.swap_window_s, adapter=adapter,
            )
            if tags:
                record["precision"] = "+".join(tags)
                for tag in tags:
                    if "achieved_imgs_per_s" in record:
                        record[f"{tag}_imgs_per_sec"] = (
                            record["achieved_imgs_per_s"]
                        )
                    if "e2e_ms_p99" in record:
                        record[f"{tag}_e2e_ms_p99"] = record["e2e_ms_p99"]
            print(json.dumps(record), flush=True)
    finally:
        if adapter is not None:
            adapter.stop()  # no adapted swap mid-drain
        client.close(drain=True)
        obs.export()  # no-op unless --obs_trace/DWT_OBS_TRACE
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
