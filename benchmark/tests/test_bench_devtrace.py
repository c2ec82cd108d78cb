"""The traced run's reading of a Chrome trace: device time by each op's own
name, a set taken by the next kernel on its stream, lost records found by
correlation id, the busy union and the idle gaps."""

from benchmark import devtrace, harness


def _ev(name, cat, ts, dur, corr, stream=7):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur,
                args=dict(correlation=corr, stream=stream))


def _trace(drop=()):
    dev = [
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 100, 40, 1),
        _ev("Memset (Device)", "gpu_memset", 140, 2, 2),
        _ev("void (anonymous namespace)::funnel_kernel<false>(Funnel)", "kernel", 142, 50, 3),
        _ev("Memset (Device)", "gpu_memset", 192, 2, 4),
        _ev("void (anonymous namespace)::totals_kernel<int>(Seeds<int>, int)", "kernel", 194, 10,
            5),
        _ev("void (anonymous namespace)::emit_kernel<int>(Seeds<int>)", "kernel", 204, 10, 6),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 300, 20, 7),
    ]
    host = [
        _ev("dispatch", "user_annotation", 90, 150, None),
        _ev("wait", "user_annotation", 214, 110, None),
        _ev("cudaMemcpyAsync", "cuda_runtime", 95, 3, 1),
        _ev("cudaMemsetAsync", "cuda_runtime", 99, 1, 2),
        _ev("cudaLaunchKernelExC", "cuda_runtime", 101, 2, 3),
        _ev("cudaMemsetAsync", "cuda_runtime", 104, 1, 4),
        _ev("cudaLaunchKernel", "cuda_runtime", 106, 2, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 109, 2, 6),
        _ev("cudaMemcpyAsync", "cuda_runtime", 112, 2, 7),
    ]
    return dict(traceEvents=[e for e in dev if e["args"]["correlation"] not in drop] + host)


def test_layers_and_sets():
    """Each metric picks its ops by name; a set goes with the kernel after it."""
    rec = devtrace.read_trace(_trace())
    assert [d.get("before") for d in rec["device"] if d["cat"] == "gpu_memset"] == [
        "void (anonymous namespace)::funnel_kernel<false>(Funnel)",
        "void (anonymous namespace)::totals_kernel<int>(Seeds<int>, int)"]
    assert rec["lost"] == []
    rec.update(info=dict(groups=2), queued=7)
    t = harness.trace_ctx(rec)
    ms = lambda names, **kw: devtrace.op_ms(t, names, **kw)
    assert ms(("funnel_kernel",)) == 52 / 1e3 / 2
    assert ms(("funnel_kernel",), with_sets=False) == 50 / 1e3 / 2
    assert ms(("totals_kernel", "emit_kernel")) == 22 / 1e3 / 2
    assert ms(("Memcpy HtoD",)) == 40 / 1e3 / 2 and ms(("Memcpy DtoH",)) == 20 / 1e3 / 2
    assert ms(("sa_walk_kernel",)) is None
    assert devtrace.op_ms(None, ("funnel_kernel",)) is None


def test_lost_records_found_by_correlation():
    rec = devtrace.read_trace(_trace(drop=(5,)))
    assert [h["corr"] for h in rec["lost"]] == [5]


def test_busy_idle_and_breakdown():
    rec = devtrace.read_trace(_trace())
    rec.update(info=dict(groups=1), queued=7)
    ctx = harness.trace_ctx(rec)
    assert ctx["window_s"] == (320 - 90) / 1e6
    assert ctx["busy_s"] == (114 + 20) / 1e6  # 100-214 and 300-320
    gaps = dict(ctx["idle_gaps"])
    assert gaps["dispatch"] == 10 / 1e6  # 90-100, before the first copy
    assert gaps["wait"] == 86 / 1e6  # 214-300
    ops = dict(ctx["device_ops"])
    assert ops["void (anonymous namespace)::funnel_kernel<false>(Funnel)"] == 50 / 1e6
    assert ctx["op_us"]["Memset (Device)"] == 4
    assert sum(ctx["set_us"].values()) == 4
