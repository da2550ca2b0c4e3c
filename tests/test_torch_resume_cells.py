"""Kill and resume beyond the policy × topology matrix of
``test_torch_resume.py`` (whose module docstring gives the contract): the
``adaptive`` selector flat async and hierarchical, ``AdaptiveMuHook``,
and availability traces, each resumed bitwise."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import read_federated_meta
from repro_torch.fed import AdaptiveMuHook, AvailabilityTrace

from test_torch_resume import (ROUNDS, assert_bitwise_resume, kill_and_resume,
                               make_spec_factory, one_torch_thread, setup)  # noqa: F401


def availability_trace():
    return AvailabilityTrace(6, p_stay_online=0.7, seed=3).masks(ROUNDS)


EXTRA_CELLS = {
    "adaptive async flat": ("adaptive", "async", "flat", {}, lambda: []),
    "adaptive sync hierarchical": ("adaptive", "sync", "hierarchical", {}, lambda: []),
    "adaptive async hierarchical": ("adaptive", "async", "hierarchical", {}, lambda: []),
    "adaptive mu hook": ("heterosel", "sync", "flat", {}, lambda: [AdaptiveMuHook()]),
    "availability sync flat": ("heterosel", "sync", "flat",
                               {"availability": availability_trace()}, lambda: []),
    "availability async hierarchical": ("heterosel_pallas", "async", "hierarchical",
                                        {"availability": availability_trace()}, lambda: []),
}


@pytest.mark.parametrize("cell", list(EXTRA_CELLS))
def test_other_cells_resume_bitwise(setup, tmp_path, cell):
    selector, policy, topology, extra, hooks = EXTRA_CELLS[cell]
    make_spec = make_spec_factory(setup, policy, topology, False, selector=selector,
                                  **extra)
    full = make_spec(hooks()).build().run()
    resumed, engine = kill_and_resume(make_spec, str(tmp_path / "ck"), "round_end", hooks)
    assert_bitwise_resume(full, resumed, engine, compact=False)
    if selector == "adaptive" and topology == "hierarchical":
        meta = read_federated_meta(str(tmp_path / "ck"))
        assert "budgets" in meta["schema"]["arrays"]
    if extra.get("availability") is not None:
        assert not (full.selected_history & ~extra["availability"]).any()
