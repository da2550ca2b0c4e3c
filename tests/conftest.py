"""Shared fixtures. NOTE: no XLA_FLAGS here by design — smoke tests and
benches must see the real (single) CPU device; only launch/dryrun.py forces
512 placeholder devices (brief, MULTI-POD DRY-RUN §0). Tests that need a
small mesh spawn a subprocess (tests/test_dryrun_small.py)."""

import numpy as np
import pytest

import jax


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when torch sees none")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)


@pytest.fixture()
def preempt_harness(tmp_path):
    """Simulated preemption: full run / killed run / resumed run.

    Returns ``run(make_spec, kill_at, *, phase='round_end', every=1)`` where
    ``make_spec(hooks)`` builds a fresh ``FederatedSpec`` with the given
    extra hooks. The harness runs the spec uninterrupted, then kills an
    identical run after round ``kill_at`` via ``KillAtRound`` (with a
    ``CheckpointHook`` saving every ``every`` rounds *before* the kill
    hook, like a real preemption landing after the save), then resumes
    from the checkpoint directory. Yields ``(full, resumed, engine)`` —
    the two FLResults plus the resumed engine (e.g. for ``start_round``).
    The whole resume test matrix builds on this instead of ad-hoc
    truncated-round loops."""
    from repro.fed import CheckpointHook, KillAtRound, SimulatedPreemption

    def run(make_spec, kill_at, *, phase="round_end", every=1):
        full = make_spec([]).build().run()
        ckdir = str(tmp_path / "preempt")
        with pytest.raises(SimulatedPreemption):
            make_spec([CheckpointHook(ckdir, every=every),
                       KillAtRound(kill_at, phase=phase)]).build().run()
        engine = make_spec([CheckpointHook(ckdir, every=every)]).build()
        resumed = engine.run()
        return full, resumed, engine

    return run
