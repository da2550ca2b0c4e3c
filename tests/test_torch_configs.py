"""The port's registry, input shapes and entry points against the reference.

* ``configs.registry``: ``ARCHS`` holds the reference's names, every config
  equals the reference's on every field the port carries, and so does every
  smoke variant (the hybrid, encoder and vlm branches included);
  ``ASSIGNED``, ``list_archs`` and ``get_shape`` as there.
* ``data.input_specs``: for every architecture and input shape, the same
  names, shapes and dtypes as the reference's ``jax.ShapeDtypeStruct``s,
  as empty tensors on the meta device.
* ``repro_torch``'s public names: the reference's that the port has.
* ``examples.quickstart`` and ``examples.federated_llm`` on the CPU: a
  short run each (the hybrid through the engine; the quickstart under both
  round policies).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro
import repro_torch
from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.synthetic import input_specs as jax_input_specs
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import input_specs
from repro_torch.examples import federated_llm, quickstart

DTYPES = {"float32": torch.float32, "int32": torch.int32, "bfloat16": torch.bfloat16,
          "bool": torch.bool}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_registry_holds_the_reference_archs():
    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    assert registry.ASSIGNED == jregistry.ASSIGNED
    assert registry.list_archs() == jregistry.list_archs()
    for name in ("zamba2-7b", "hubert-xlarge", "llama-3.2-vision-90b", "minicpm-2b",
                 "yi-9b", "llama3-405b"):
        assert name in registry.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-5")


@pytest.mark.parametrize("arch", list(jregistry.ARCHS))
def test_config_and_smoke_variant_equal_the_reference_field_for_field(arch):
    cfg, want = registry.get_config(arch), jregistry.get_config(arch)
    smoke, want_smoke = registry.smoke_variant(cfg), jregistry.smoke_variant(want)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert getattr(smoke, f.name) == getattr(want_smoke, f.name), f.name
    assert cfg.padded_vocab == want.padded_vocab
    assert cfg.resolved_head_dim == want.resolved_head_dim


def test_shapes_equal_the_reference():
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        got, want = registry.get_shape(name), jregistry.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", list(jregistry.ARCHS))
def test_input_specs_equal_the_reference(arch):
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        got = input_specs(registry.get_config(arch), registry.get_shape(name))
        want = jax_input_specs(jregistry.get_config(arch), jregistry.get_shape(name))
        assert list(got) == list(want), (arch, name)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), t.dtype) == (tuple(want[key].shape),
                                                 DTYPES[str(want[key].dtype)]), (arch, key)
    small = ShapeConfig(name="tiny", seq_len=7, global_batch=3, kind="train")
    got = input_specs(registry.get_config(arch), small)
    want = jax_input_specs(jregistry.get_config(arch),
                           JaxShapeConfig(name="tiny", seq_len=7, global_batch=3, kind="train"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_package_reexports_the_reference_public_api():
    assert repro_torch.__all__ == repro.__all__
    for name in repro_torch.__all__:
        assert callable(getattr(repro_torch, name)) or isinstance(
            getattr(repro_torch, name), type), name


@pytest.mark.parametrize("policy", ["sync", "async"])
def test_quickstart_runs_on_the_cpu_and_refuses_async(capsys, policy):
    """Each round policy runs on the CPU and prints its summary: sync with
    the fused selector and FedAvgM, flat and hierarchical; async with a
    deadline, over-selection, stragglers and FedBuff. (The name predates
    the async port, which this slice added; the refusals it pinned are
    gone.)"""
    if policy == "sync":
        res = quickstart.main(["--rounds", "2", "--device", "cpu", "--selector",
                               "heterosel_pallas", "--aggregator", "fedavgm"])
        assert res.selected_history.sum(1).tolist() == [6, 6]
        hier = quickstart.main(["--rounds", "1", "--device", "cpu", "--topology",
                                "hierarchical", "--edges", "3", "--executor", "sequential"])
        assert hier.cloud_uploads is not None
        with pytest.raises(SystemExit):   # straggler factors need the clock
            quickstart.main(["--straggler-factor", "10", "--device", "cpu"])
    else:
        res = quickstart.main(["--rounds", "2", "--device", "cpu", "--round-policy", "async",
                               "--deadline", "1.5", "--over-select", "0.5",
                               "--straggler-factor", "3", "--aggregator", "fedbuff"])
        assert res.wall_clock is not None and len(res.wall_clock) == 2
        assert res.selected_history.sum(1).max() <= 9   # ⌈6·1.5⌉ dispatched at most
    assert res.selected_history.shape == (2, 12)
    out = capsys.readouterr().out
    assert "paper metrics (eval metric: accuracy)" in out
    assert ("simulated wall-clock" in out) == (policy == "async")
    with pytest.raises(SystemExit):
        quickstart.main(["--edges", "3", "--device", "cpu"])


def test_federated_llm_runs_the_hybrid_through_the_engine():
    res = federated_llm.main(["--arch", "zamba2-7b", "--rounds", "2", "--device", "cpu"])
    assert res.metric_name == "exp(-loss)"
    assert res.selected_history.sum(1).tolist() == [4, 4]
    assert np.all(np.isfinite(res.train_loss))
    assert any(k.startswith("shared_attn.") for k in res.params)
    with pytest.raises(SystemExit):
        federated_llm.main(["--arch", "hubert-xlarge", "--device", "cpu"])
