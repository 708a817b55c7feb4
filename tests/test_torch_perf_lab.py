"""The timer of the port's lab tools and chip_smoke.py, on the CPU: the
device-side wait that holds the stream between the L2 flush and the start
event lasts at least twice the host's dispatch of one call, so that every
launch of the call is queued before the start event runs. The wait itself
(torch.cuda._sleep) runs only on the card."""
import pytest

from latteclip_torch.tools import perf_lab


@pytest.mark.parametrize("host_ms,cycles_per_ms,expected", [
    (0.2, 1.98e6, 792000),    # 0.4 ms at 1980 MHz
    (1.5, 1.755e6, 5265000),  # SDPA's backward through autograd, 3 ms
    (0.0, 1.98e6, 99000),     # the floor: 0.05 ms
    (0.01, 1e6, 50000),
])
def test_wait_cycles_outlast_twice_the_host_dispatch(host_ms, cycles_per_ms, expected):
    cycles = perf_lab.wait_cycles(host_ms, cycles_per_ms)
    assert cycles == expected
    assert cycles / cycles_per_ms >= max(2 * host_ms, perf_lab.MIN_WAIT_MS) - 1e-12


@pytest.mark.parametrize("host_ms,cycles_per_ms", [(-1.0, 1e6), (1.0, 0.0)])
def test_wait_cycles_refuse_a_bad_calibration(host_ms, cycles_per_ms):
    with pytest.raises(ValueError):
        perf_lab.wait_cycles(host_ms, cycles_per_ms)


def test_cpu_timer_uses_the_host_clock():
    timer = perf_lab.Timer("cpu", iters=3)
    assert timer.clock() == "cpu host clock"
    assert timer(lambda: sum(range(100))) >= 0.0
