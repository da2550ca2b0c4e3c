"""Synthetic federated data, as in ``repro.data.synthetic``: vision (a
CIFAR-10 stand-in; at cross-device scale lazily materialized, and with a
label skew that drifts mid-run) and language modelling (per-client bigram
"dialects"),
and the model inputs of each (architecture, input shape) as empty tensors
on the meta device (``input_specs``).

Everything is generated in numpy from the seed, so images, labels, client
index lists and token streams are bitwise equal to the reference's. Batches
become torch tensors (on the CPU) at the boundary; the executor moves them
to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, ModelConfig, ShapeConfig
from repro_torch.core.state import ClientState, init_client_state
from repro_torch.fed.partition import (client_label_js, dirichlet_partition,
                                       js_divergence)


def _class_templates(rng: np.random.Generator, num_classes: int, size: int) -> np.ndarray:
    """Smooth class templates: low-frequency random fields, upsampled."""
    low = rng.normal(size=(num_classes, size // 4, size // 4, 3))
    up = np.repeat(np.repeat(low, 4, axis=1), 4, axis=2)
    return up / np.abs(up).max(axis=(1, 2, 3), keepdims=True)


@dataclasses.dataclass
class VisionFedData:
    """Per-client non-IID image classification data (Dirichlet label skew)."""

    images: np.ndarray          # (N, H, W, 3) float32, NHWC
    labels: np.ndarray          # (N,) int32
    client_indices: List[np.ndarray]
    label_dists: np.ndarray     # (K, C)
    label_js: np.ndarray        # (K,)
    test_images: np.ndarray
    test_labels: np.ndarray

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def client_batches(self, k: int, steps: int, batch: int,
                       rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """(steps, batch, ...) draws with replacement from client k's data."""
        idx = self.client_indices[k]
        pick = rng.choice(idx, size=(steps, batch), replace=True)
        return {
            "images": torch.from_numpy(self.images[pick]),
            "labels": torch.from_numpy(self.labels[pick]),
        }

    def eval_batch(self) -> Dict[str, torch.Tensor]:
        return {
            "images": torch.from_numpy(self.test_images),
            "labels": torch.from_numpy(self.test_labels),
        }


def make_vision_data(
    fed: FedConfig,
    *,
    num_classes: int = 10,
    image_size: int = 32,
    train_per_class: int = 256,
    test_per_class: int = 64,
    noise: float = 0.8,
    seed: int | None = None,
) -> VisionFedData:
    seed = fed.seed if seed is None else seed
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, num_classes, image_size)

    def sample(n_per_class):
        labels = np.repeat(np.arange(num_classes), n_per_class)
        imgs = templates[labels] + noise * rng.normal(
            size=(len(labels), image_size, image_size, 3)
        )
        return imgs.astype(np.float32), labels.astype(np.int32)

    images, labels = sample(train_per_class)
    test_images, test_labels = sample(test_per_class)
    client_indices, dists = dirichlet_partition(
        labels, fed.num_clients, fed.dirichlet_alpha, seed=seed
    )
    return VisionFedData(
        images=images, labels=labels,
        client_indices=client_indices, label_dists=dists,
        label_js=client_label_js(dists),
        test_images=test_images, test_labels=test_labels,
    )


# ---------------------------------------------------------------------------
# Vision at cross-device scale: lazily materialized label-skew federation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LazyVisionFedData:
    """K=10⁴-scale label-skew federation, materialized lazily per round.

    Nothing per-sample is stored: each client k exists only as a row of
    ``label_dists`` (its Dirichlet label distribution). Batches are
    synthesized on demand — labels drawn from the client's distribution,
    pixels from the shared class templates + client-seeded noise — so memory
    is O(K·C + C·H·W), not O(N·H·W). ``stacked_client_batches`` emits the
    whole selected cohort in one vectorized numpy pass with a leading (M,)
    client axis, which the batched executor takes (``fed.batched``).
    """

    templates: np.ndarray       # (C, H, W, 3) shared class templates
    label_dists: np.ndarray     # (K, C) per-client Dirichlet label dist
    label_js: np.ndarray        # (K,) JS(P_k || P_avg)
    noise: float
    test_images: np.ndarray
    test_labels: np.ndarray

    @property
    def num_clients(self) -> int:
        return self.label_dists.shape[0]

    def _synthesize(self, labels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        imgs = self.templates[labels] + self.noise * rng.standard_normal(
            labels.shape + self.templates.shape[1:], dtype=np.float32)
        return imgs.astype(np.float32)

    def _sample_labels(self, ks: np.ndarray, n: int,
                       rng: np.random.Generator) -> np.ndarray:
        """(len(ks), n) labels, row i drawn from client ks[i]'s distribution."""
        cdf = np.cumsum(self.label_dists[np.asarray(ks, np.int64)], axis=1)
        u = rng.random((len(ks), n, 1))
        return (u > cdf[:, None, :]).sum(axis=2).astype(np.int32)

    def client_batches(self, k: int, steps: int, batch: int,
                       rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        labels = self._sample_labels(np.asarray([k]), steps * batch, rng)[0]
        imgs = self._synthesize(labels, rng)
        h, w = self.templates.shape[1], self.templates.shape[2]
        return {"images": torch.from_numpy(imgs.reshape(steps, batch, h, w, 3)),
                "labels": torch.from_numpy(labels.reshape(steps, batch))}

    def stacked_client_batches(self, selected: np.ndarray, steps: int, batch: int,
                               rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """One cohort in one pass: leaves shaped (M, steps, batch, ...)."""
        sel = np.asarray(selected)
        m, n = len(sel), steps * batch
        labels = self._sample_labels(sel, n, rng)          # (M, n)
        imgs = self._synthesize(labels, rng)               # (M, n, H, W, 3)
        h, w = self.templates.shape[1], self.templates.shape[2]
        return {"images": torch.from_numpy(imgs.reshape(m, steps, batch, h, w, 3)),
                "labels": torch.from_numpy(labels.reshape(m, steps, batch))}

    def eval_batch(self) -> Dict[str, torch.Tensor]:
        return {"images": torch.from_numpy(self.test_images),
                "labels": torch.from_numpy(self.test_labels)}


def make_lazy_vision_data(
    fed: FedConfig,
    *,
    num_classes: int = 10,
    image_size: int = 32,
    test_per_class: int = 16,
    noise: float = 0.8,
    seed: int | None = None,
) -> LazyVisionFedData:
    """Label-skew federation with ``fed.num_clients`` lazily backed clients.

    Each client's label distribution is drawn directly from Dir(α): the same
    skew model at unbounded K with no per-sample storage (K=10⁴ costs ~K·C
    floats of state, < 1 MB).
    """
    seed = fed.seed if seed is None else seed
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, num_classes, image_size).astype(np.float32)
    dists = rng.dirichlet(
        np.full(num_classes, fed.dirichlet_alpha), size=fed.num_clients
    ).astype(np.float64)
    test_labels = np.repeat(np.arange(num_classes), test_per_class).astype(np.int32)
    test_images = (
        templates[test_labels]
        + noise * rng.standard_normal(
            (len(test_labels), image_size, image_size, 3), dtype=np.float32)
    ).astype(np.float32)
    return LazyVisionFedData(
        templates=templates, label_dists=dists, label_js=client_label_js(dists),
        noise=noise, test_images=test_images, test_labels=test_labels)


# ---------------------------------------------------------------------------
# Label-distribution drift: skew that rotates mid-run (fed/scenarios.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DriftingVisionFedData(LazyVisionFedData):
    """Label-skew federation whose per-client skew *rotates* during the run.

    Every ``drift_period`` rounds each client's Dirichlet label distribution
    is rolled ``drift_shift`` classes along the class axis: its shape (and
    so its label_js divergence) is kept, but which classes a client favours
    changes, so selection metadata learned before a drift boundary goes
    stale. ``fed.scenarios.LabelDriftHook`` calls :meth:`set_round` at every
    round start and batch sampling reads the rotated distributions.

    Batches are a pure function of the engine's (checkpointed) numpy stream
    and the round index, so drifted runs stay seed-deterministic and resume
    bitwise. ``label_js`` stays the round-0 snapshot: rolling a distribution
    leaves its divergence from the permutation-symmetric average unchanged.
    """

    drift_period: int = 10
    drift_shift: int = 1
    _round: int = 0

    def __post_init__(self):
        if self.drift_period < 1:
            raise ValueError("drift_period must be >= 1")

    def set_round(self, round_idx: int) -> None:
        """Position the drift clock; idempotent, called by LabelDriftHook."""
        self._round = int(round_idx)

    def current_shift(self) -> int:
        num_classes = self.label_dists.shape[1]
        return ((self._round // self.drift_period) * self.drift_shift) % num_classes

    def current_label_dists(self) -> np.ndarray:
        """(K, C) distributions in effect at the current round."""
        return np.roll(self.label_dists, self.current_shift(), axis=1)

    def _sample_labels(self, ks: np.ndarray, n: int,
                       rng: np.random.Generator) -> np.ndarray:
        cdf = np.cumsum(self.current_label_dists()[np.asarray(ks, np.int64)], axis=1)
        u = rng.random((len(ks), n, 1))
        return (u > cdf[:, None, :]).sum(axis=2).astype(np.int32)


def make_drifting_vision_data(
    fed: FedConfig,
    *,
    drift_period: int = 10,
    drift_shift: int = 3,
    num_classes: int = 10,
    image_size: int = 32,
    test_per_class: int = 16,
    noise: float = 0.8,
    seed: int | None = None,
) -> DriftingVisionFedData:
    """``make_lazy_vision_data`` whose label skew rotates every
    ``drift_period`` rounds (the 'drift' scenario, ``fed.scenarios``)."""
    base = make_lazy_vision_data(
        fed, num_classes=num_classes, image_size=image_size,
        test_per_class=test_per_class, noise=noise, seed=seed)
    return DriftingVisionFedData(
        templates=base.templates, label_dists=base.label_dists,
        label_js=base.label_js, noise=base.noise, test_images=base.test_images,
        test_labels=base.test_labels, drift_period=drift_period,
        drift_shift=drift_shift)


# ---------------------------------------------------------------------------
# Language modelling: per-client "dialect" token streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMFedData:
    """Per-client token streams. Heterogeneity = client-specific bigram rules."""

    vocab: int
    seq_len: int
    rules: np.ndarray   # (K, 2) int — affine bigram rule per client
    label_js: np.ndarray

    @property
    def num_clients(self) -> int:
        return len(self.rules)

    def _sample(self, k: int, n: int, rng: np.random.Generator) -> np.ndarray:
        a, b = self.rules[k]
        toks = np.empty((n, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=n)
        noise = rng.random((n, self.seq_len)) < 0.1
        rand = rng.integers(0, self.vocab, size=(n, self.seq_len))
        for t in range(1, self.seq_len):
            nxt = (toks[:, t - 1] * a + b) % self.vocab
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def client_batches(self, k: int, steps: int, batch: int,
                       rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """(steps, batch, seq_len) token draws for client k."""
        toks = torch.from_numpy(
            self._sample(k, steps * batch, rng).reshape(steps, batch, self.seq_len))
        return {"tokens": toks, "labels": toks}

    def eval_batch(self, batch: int = 32) -> Dict[str, torch.Tensor]:
        """A fixed held-out batch, ``batch // K`` sequences from each client."""
        rng = np.random.default_rng(1234)
        per = max(batch // self.num_clients, 1)
        toks = torch.from_numpy(np.concatenate(
            [self._sample(k, per, rng) for k in range(self.num_clients)]))
        return {"tokens": toks, "labels": toks}


def make_lm_data(fed: FedConfig, vocab: int, seq_len: int = 64) -> LMFedData:
    rng = np.random.default_rng(fed.seed)
    a = rng.choice([3, 5, 7, 11, 13, 17, 19, 23], size=fed.num_clients)
    b = rng.integers(0, vocab, size=fed.num_clients)
    rules = np.stack([a, b], axis=1)
    # Rule distance as a diversity proxy: JS over each rule's induced unigram
    # histogram (token ids folded into min(vocab, 64) bins).
    hists = np.zeros((fed.num_clients, min(vocab, 64)))
    for k in range(fed.num_clients):
        s = LMFedData(vocab, seq_len, rules, np.zeros(fed.num_clients))._sample(
            k, 8, np.random.default_rng(k))
        hists[k] = np.bincount(s.ravel() % hists.shape[1], minlength=hists.shape[1])
    hists = hists / hists.sum(axis=1, keepdims=True)
    js = js_divergence(hists, hists.mean(axis=0, keepdims=True))
    return LMFedData(vocab=vocab, seq_len=seq_len, rules=rules, label_js=js)


def synthetic_client_state(k: int, seed: int = 0, *,
                           device: str | torch.device = "cuda") -> ClientState:
    """A mid-training (K,) selection state: ~90 % of clients observed
    (losses in [0.3, 3), the one before 10 % higher, up to 19
    participations, last seen in rounds 0–6, ‖Δw‖² in [0, 2)), the rest
    never. The port's copy of the population-scale selector table's state
    (reference ``benchmarks/table8_selector.py:61``), drawn with numpy from
    ``seed`` instead of ``jax.random``."""
    rng = np.random.default_rng(seed)
    js = rng.uniform(0.0, 0.7, k).astype(np.float32)
    observed = rng.uniform(size=k) < 0.9
    loss = rng.uniform(0.3, 3.0, k).astype(np.float32)
    part = rng.integers(0, 20, k)
    last = rng.integers(0, 7, k)
    sq = rng.uniform(0.0, 2.0, k).astype(np.float32)
    state = init_client_state(k, js, device="cpu")
    obs_t = torch.from_numpy(observed)
    loss_t = torch.from_numpy(loss)
    state = dataclasses.replace(
        state,
        loss_prev=torch.where(obs_t, loss_t, 0.0),
        loss_prev2=torch.where(obs_t, loss_t * 1.1, 0.0),
        part_count=torch.where(obs_t, torch.from_numpy(part).to(torch.int32), 0
                               ).to(torch.int32),
        last_selected=torch.where(obs_t, torch.from_numpy(last).to(torch.int32),
                                  state.last_selected),
        update_sqnorm=torch.where(obs_t, torch.from_numpy(sq), 0.0),
        has_loss=obs_t.to(torch.float32),
        has_momentum=obs_t.to(torch.float32),
    )
    return state.map(lambda x: x.to(device))


# ---------------------------------------------------------------------------
# Model inputs of an (architecture, input shape), without storage
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The model inputs for (arch × input shape) as empty tensors on the meta
    device (each a shape and a dtype, as the reference's
    ``jax.ShapeDtypeStruct``).

    train/prefill: the full (global_batch, seq_len) batch. decode: one new
    token per sequence. The encoder takes frame embeddings, a mask of the
    masked positions and cluster labels; the vlm adds projected vision
    embeddings (batch, vision_tokens, d_model).
    """
    b, s = shape.global_batch, shape.seq_len
    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if cfg.family == "resnet":
        return {"images": spec((b, cfg.image_size, cfg.image_size, 3), f32),
                "labels": spec((b,), i32)}
    if cfg.family == "encoder":
        return {"frames": spec((b, s, cfg.d_model), bf16),
                "mask": spec((b, s), torch.bool),
                "labels": spec((b, s), i32)}
    if shape.kind == "decode":
        out = {"tokens": spec((b, 1), i32)}
    else:
        out = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = spec((b, cfg.vision_tokens, cfg.d_model), bf16)
    return out
