"""The port's Figure 2/3 model (``repro_torch.core.workflows``) held
exactly to the reference's ``benchmarks/fig2_workflows.py`` and
``benchmarks/fig3_autoscaling.py``, on the CPU: the three workflows'
batch times at τ = 90 s for every batch of ``BATCHES``, and Figure 3's
per-minute instance averages and cold starts for a 50-slide burst. The
tests import ``repro`` and ``benchmarks``; the module imports neither
(``tests/test_torch_isolation.py``)."""
import pytest

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from benchmarks import fig2_workflows as ref2
from benchmarks import fig3_autoscaling as ref3
from repro_torch.core import workflows as W

TAU = 90.0


def test_batches_are_the_reference_batches():
    assert W.BATCHES == ref2.BATCHES


@pytest.mark.parametrize("name", ["serial_time", "parallel_time",
                                  "autoscaling_time"])
@pytest.mark.parametrize("n", ref2.BATCHES)
def test_workflow_times_equal_the_reference(name, n):
    assert getattr(W, name)(n, TAU) == getattr(ref2, name)(n, TAU)


def test_fleet_autoscaling_time_equals_the_reference():
    kw = dict(fleet={}, ordered_ingest=True)
    assert W.autoscaling_time(10, TAU, **kw) == \
        ref2.autoscaling_time(10, TAU, **kw)


def test_fig3_run_equals_the_reference():
    minutes, pipe = W.fig3_run(n=50)
    want, ref_pipe = ref3.run(n=50)
    assert minutes == want
    assert pipe.service.cold_starts == ref_pipe.service.cold_starts
    assert pipe.done_count() == ref_pipe.done_count() == 50
    assert max(v for _, v in minutes) >= 45 and minutes[-1][1] == 0


def test_minute_averages_equal_the_reference():
    series = [(0.0, 0.0), (12.5, 3.0), (61.0, 7.0), (130.0, 2.0),
              (200.0, 0.0)]
    assert W.minute_averages(series) == ref3.minute_averages(series)


def test_measure_service_time_converts_on_the_cpu():
    t = W.measure_service_time(side=256, device="cpu")
    assert isinstance(t, float) and t > 0.0


def test_measure_service_time_refuses_a_missing_card(monkeypatch):
    """No fallback: the default device is the card, and without one the
    measurement raises instead of timing the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.measure_service_time(side=256)
