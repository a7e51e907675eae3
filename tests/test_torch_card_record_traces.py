"""``chip_smoke.py``'s profiler records keep complete traces only, by their
host side (the profiler is fed by hand: no card runs here).

* ``device_ms`` keeps the traces that hold the call's full count of device
  activities (the most any trace held), reports how many it kept, and
  records the time as lost when every trace came back empty.
* ``kernel_device_split`` with each name's own count accepts a trace only
  when every name holds its count, where the total alone would pass a trace
  that lost one kernel and doubled another.
* ``library_fields`` carries the kept traces beside the device time.
"""

import pytest

import chip_smoke


class _Torch:
    class cuda:
        synchronize = staticmethod(lambda: None)


def _feed(monkeypatch, traces):
    traces = iter(traces)
    monkeypatch.setattr(chip_smoke, "profiled", lambda torch_, fn: None)
    monkeypatch.setattr(chip_smoke, "device_by_name", lambda prof: next(traces))


def test_device_ms_keeps_only_traces_with_the_full_count(monkeypatch):
    full = {"gemm": (0.30, 2), "softmax": (0.05, 1)}
    _feed(monkeypatch, [{}, full, {"gemm": (0.17, 1)}, {},
                        {"gemm": (0.31, 2), "softmax": (0.06, 1)}])
    median, traces = chip_smoke.device_ms(_Torch, lambda: None, reps=5)
    assert traces == {"kept": 2, "traces": 5, "activities": 3}
    assert median == pytest.approx((0.35 + 0.37) / 2)


def test_device_ms_of_empty_traces_is_lost(monkeypatch):
    _feed(monkeypatch, [{}] * 3)
    median, traces = chip_smoke.device_ms(_Torch, lambda: None, reps=3)
    assert median is None and traces == {"kept": 0, "traces": 3, "activities": 0}
    fields = chip_smoke.library_fields((0.4, median, traces, None), bound_ms=0.1)
    assert fields["library_device_ms"] is None and fields["library_ms"] == 0.4
    assert "none of 3" in fields["library_lost"]["device"]
    assert fields["library_device_traces"] == traces


def test_kernel_device_split_requires_each_names_count(monkeypatch):
    split_k, combine_k = "decode_split_kernel<64>", "decode_combine_kernel<64>"
    traces = [{split_k: (0.020, 2)},                                  # combine lost
              {split_k: (0.018, 1), combine_k: (0.004, 1)},
              {combine_k: (0.003, 1)},                                # split lost
              {split_k: (0.019, 1), combine_k: (0.005, 1)},
              {split_k: (0.020, 1), combine_k: (0.004, 1)}]
    names = ("decode_split_kernel", "decode_combine_kernel")
    _feed(monkeypatch, list(traces))
    median, incomplete, split, held = chip_smoke.kernel_device_split(
        _Torch, lambda: None, names, dict.fromkeys(names, 1), reps=3, tries=10)
    assert (median, incomplete) == (pytest.approx(0.024), 2)
    assert split == {"decode_split_kernel": pytest.approx(0.019),
                     "decode_combine_kernel": pytest.approx(0.004)}
    assert [h["matched"] for h in held] == [{split_k: 2}, {combine_k: 1}]
    # by the total alone the first trace (two splits, no combine) passes
    _feed(monkeypatch, list(traces))
    median, incomplete, _, _ = chip_smoke.kernel_device_split(
        _Torch, lambda: None, names, 2, reps=3, tries=10)
    assert incomplete == 1 and median == pytest.approx(0.022)
