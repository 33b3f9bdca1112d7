"""Planner calibration of the port: the measurement pass, the persisted
``calibration.json`` and calibrated planning, against the reference."""
import importlib
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import clean_fraction_bits
from repro import query as RQ
from repro.core import calibration as RCal
from repro.core.planner import plan_threshold as r_plan_threshold
from repro.persist import calibration as RPer
from repro_torch import persist as TPersist
from repro_torch import query as TQ
from repro_torch.convert import index_from_reference_arrays
from repro_torch.core import calibration as TCal
from repro_torch.core.planner import plan_threshold as t_plan_threshold
from repro_torch.core.threshold import ALGORITHMS


@pytest.fixture(autouse=True)
def _no_calibration():
    """Tests here install calibrations; never leak one into other tests."""
    for mod in (RCal, TCal):
        mod.clear_calibration()
    yield
    for mod in (RCal, TCal):
        mod.clear_calibration()


def test_measure_calibration_defaults_and_no_except():
    ref = inspect.signature(RCal.measure_calibration).parameters
    got = inspect.signature(TCal.measure_calibration).parameters
    for name in ("backends", "n", "n_words", "repeats", "seed"):
        assert got[name].default == ref[name].default, name
    assert got["device"].default is None
    assert TCal.DEFAULT_BACKENDS == RCal.DEFAULT_BACKENDS
    assert "except" not in inspect.getsource(TCal.measure_calibration)


def test_measure_calibration_prices_the_reference_backend_set():
    got = TCal.measure_calibration(device="cpu", n_words=256)
    want = RCal.measure_calibration(n_words=256)
    assert got.device == TCal.device_signature("cpu") == "cpux1"
    assert set(got.us_per_kword) == set(want.us_per_kword)
    assert got.samples == want.samples
    assert all(v > 0 and np.isfinite(v) for v in got.us_per_kword.values())


def test_measure_calibration_skips_only_what_the_model_cannot_price():
    got = TCal.measure_calibration(("fused", "rbmrg_block", "dsk", "looped"), n=8,
                                   n_words=64, repeats=1, device="cpu")
    want = RCal.measure_calibration(("fused", "rbmrg_block", "dsk", "looped"), n=8,
                                    n_words=64, repeats=1)
    assert set(got.us_per_kword) == set(want.us_per_kword)


def test_measure_calibration_raises_on_a_failing_backend(monkeypatch):
    """The reference skips a backend that raises; in the port every default
    backend runs, so a failure is a fault and propagates."""
    from repro_torch.query import executors

    def broken(*_a, **_k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(executors, "_device_threshold", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        TCal.measure_calibration(("fused", "looped"), n_words=64, device="cpu")


def test_persist_exports_and_round_trip(tmp_path):
    ref_all = importlib.import_module("repro.persist").__all__
    assert sorted(TPersist.__all__) == sorted(ref_all)
    assert {"ensure_calibration", "load_calibration", "save_calibration"} <= set(TPersist.__all__)
    c = TCal.Calibration(device="identity", us_per_kword={"ssum": 2.5, "fused": 0.5},
                         dispatch_us={"fused": 40.0}, samples={"ssum": 3})
    target = TPersist.save_calibration(c, tmp_path)
    assert target.name == "calibration.json"
    back = TPersist.load_calibration(tmp_path)
    assert back is not None and back.to_obj() == c.to_obj()
    # the file is the reference's: each package reads the other's
    ref_back = RPer.load_calibration(tmp_path)
    assert ref_back is not None and ref_back.to_obj() == c.to_obj()
    RPer.save_calibration(RCal.Calibration(device="identity", us_per_kword={"looped": 7.0}),
                          tmp_path / "ref")
    assert TPersist.load_calibration(tmp_path / "ref").us_per_kword == {"looped": 7.0}
    assert TPersist.load_calibration(tmp_path / "absent") is None
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "calibration.json").write_text("{not json")
    assert TPersist.load_calibration(tmp_path / "bad") is None


@pytest.mark.parametrize("stamp,accepted", [
    ("tpux4", False), ("cudax1", False), ("cpux8", False), ("some_tpu", False),
    ("identity", True), ("cpux1", True), ("cpu", True),
])
def test_device_mismatch_refused_on_the_cpu(tmp_path, stamp, accepted):
    c = TCal.Calibration(device=stamp, us_per_kword={"ssum": 9.0})
    TPersist.save_calibration(c, tmp_path)
    got = TPersist.load_calibration(tmp_path, device="cpu")
    assert (got is not None) == accepted
    if accepted and stamp == "cpu":
        assert got.device == "cpux1"  # a bare device type adopts the signature
    loose = TPersist.load_calibration(tmp_path, allow_mismatch=True, device="cpu")
    assert loose is not None and loose.us_per_kword["ssum"] == 9.0


def test_card_stamp_refuses_a_cpu_file(tmp_path):
    """A file measured on the CPU is stale for the card (decided by the
    signature, so this holds without a card)."""
    TPersist.save_calibration(TCal.Calibration(device="cpux1", us_per_kword={"ssum": 1.0}),
                              tmp_path)
    obj = json.loads((tmp_path / "calibration.json").read_text())
    assert obj["device"] == "cpux1"
    cal = TCal.Calibration.from_obj(obj)
    assert cal.is_stale("cudax1") and not cal.is_stale("cpux1")


def test_ensure_calibration_loads_or_measures(tmp_path):
    c = TCal.Calibration(device="identity", us_per_kword={"fused": 0.5})
    TPersist.save_calibration(c, tmp_path)
    got = TPersist.ensure_calibration(tmp_path, repeats=1, n_words=64, device="cpu")
    assert got.to_obj() == c.to_obj()  # loaded, not re-measured
    assert TCal.get_calibration() is got
    fresh = TPersist.ensure_calibration(tmp_path / "new", repeats=1, n_words=64,
                                        device="cpu", activate=False)
    assert fresh.device == "cpux1" and set(fresh.us_per_kword) >= {"fused", "looped"}
    assert TCal.get_calibration() is got
    again = TPersist.load_calibration(tmp_path / "new", device="cpu")
    assert again is not None and again.to_obj() == fresh.to_obj()


def _bench_pair(cf, seed):
    bits = clean_fraction_bits(8, cf, seed=seed, n_tiles=8, tail_bits=0)
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits))
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    return ref, tor


@pytest.mark.parametrize("victim", ("best", "fused", "looped", "scancount_streaming"))
def test_skewed_calibration_steers_like_the_reference(victim):
    """A calibration that says one backend is slow steers both planners to
    the same other backend, with the same µs prices."""
    ref, tor = _bench_pair(0.0, seed=1)
    n = 8
    r_stats, t_stats = ref.store.member_stats(None), tor.store.member_stats(None)
    base = t_plan_threshold(n, n // 2, stats=t_stats, fused_available=True)
    r_base = r_plan_threshold(n, n // 2, stats=r_stats, fused_available=True)
    assert (base.algorithm, base.cost, base.candidates) == (r_base.algorithm, r_base.cost,
                                                            r_base.candidates)
    slow = base.algorithm if victim == "best" else victim
    r_skew = RCal.Calibration.identity(ALGORITHMS)
    t_skew = TCal.Calibration.identity(ALGORITHMS)
    r_skew.us_per_kword[slow] = t_skew.us_per_kword[slow] = 1e6
    RCal.set_calibration(r_skew)
    TCal.set_calibration(t_skew)
    want = r_plan_threshold(n, n // 2, stats=r_stats, fused_available=True)
    got = t_plan_threshold(n, n // 2, stats=t_stats, fused_available=True)
    assert got.algorithm == want.algorithm
    assert (got.cost, got.cost_us, got.candidates_us) == (want.cost, want.cost_us,
                                                          want.candidates_us)
    if victim == "best":
        assert got.algorithm != base.algorithm and "calibrated" in got.rationale
    # and through the index's planner, which the calibration generation
    # keeps from serving a stale memo
    assert tor.explain(TQ.Threshold(4)).algorithm == ref.explain(RQ.Threshold(4)).algorithm
    q_ref, q_tor = RQ.Threshold(4), TQ.Threshold(4)
    assert np.array_equal(np.asarray(ref.execute(q_ref)),
                          tor.execute(q_tor).numpy().view(np.uint32))
    assert tor.last_info == ref.last_info


def test_measured_calibration_plans_and_executes_on_the_cpu():
    """Constants measured on the CPU steer the port's planner to a backend
    that runs and answers as the uncalibrated plan does."""
    ref, tor = _bench_pair(0.5, seed=3)
    want = {t: np.asarray(ref.execute(RQ.Threshold(t))) for t in (2, 3, 5, 7)}
    TCal.set_calibration(TCal.measure_calibration(n=8, n_words=256, repeats=1, device="cpu"))
    for t, w in want.items():
        plan = tor.explain(TQ.Threshold(t), memo=False)
        assert plan.cost_us is not None
        assert np.array_equal(tor.execute(TQ.Threshold(t)).numpy().view(np.uint32), w)
