"""Probabilistic client selection — paper Eq (12) + the paper's baselines.

HeteRo-Select: softmax over scores with dynamic temperature
τ(t) = τ0·(1 − 0.5·min(t/100, 1)), then m clients without replacement by
Gumbel-top-m. Baselines (paper Sec V): ``random`` (uniform, FedAvg),
``power_of_choice`` (d uniform candidates, the m with the highest loss) and
``oort`` (statistical × system utility with an explore split). ``adaptive``
(heterogeneity-guided sampling, arXiv:2310.00198) rescales the softmax
temperature by the observed spread of client losses; the hierarchical
engine pairs it with ``core.adaptive.AdaptiveBudgets``. ``filtered`` /
``filtered:<base>`` (FilFL-style pre-selection filtering,
arXiv:2302.06599) prunes the candidate pool to the top keep_frac·K clients
by optimistic utility before the base selector's probabilities are
re-sampled inside it.

torch cannot reproduce ``jax.random``, so every selector takes its random
draws as its first argument: ``(draws, state, round_idx) ->
(selected_mask, probs)``. ``draws`` is the (K,) f32 Gumbel row, or a mapping
of named (K,) rows (``DRAW_NAMES``) for a selector that takes more than one
(``selector_draws``). The engine draws them (``draw``) or takes them from
the caller. ``make_async_selector`` gives the asynchronous engine's 4-argument
selectors, ``(draws, state, round_idx, staleness)``: the virtual clock's
(K,) staleness takes the place of the round counter in Eq 7.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core.scoring import HeteRoScoreConfig, compute_scores
from repro_torch.core.state import ClientState, staleness
from repro_torch.kernels._math import log as _log
from repro_torch.kernels.score_select import order_keys

Draws = Union[torch.Tensor, Mapping[str, torch.Tensor]]
SelectFn = Callable[[Draws, ClientState, int], Tuple[torch.Tensor, torch.Tensor]]
AsyncSelectFn = Callable[[Draws, ClientState, int, torch.Tensor],
                         Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    """Selection-policy hyper-parameters (paper Sec III-B.6)."""

    num_selected: int = 6          # m — clients per round (50% of 12)
    tau0: float = 1.0              # base softmax temperature τ0
    tau_decay_rounds: int = 100    # the /100 in τ(t)
    additive: bool = True          # Eq (1) vs Eq (2)
    poc_candidates: int = 0        # Power-of-Choice d (0 ⇒ 2m)
    oort_explore_frac: float = 0.1 # Oort ε — fraction of slots for exploration
    oort_staleness_coef: float = 0.1
    oort_system_alpha: float = 2.0 # Oort system-utility exponent
    # Score + softmax + sampling through the fused kernels
    # (kernels.score_select); additive form only.
    use_fused_kernel: bool = False
    # 'filtered' pre-selection stage (FilFL): keep ceil(keep_frac·K) clients
    # (never fewer than m) by optimistic loss + diversity before scoring.
    filter_keep_frac: float = 0.5
    filter_diversity_coef: float = 0.5
    # 'adaptive' temperature controller: τ ← τ(t)·clip(1 + gain·(cv − ref),
    # scale_min, scale_max), cv the observed-loss coefficient of variation
    # (no observation yet ⇒ scale 1, plain heterosel).
    tau_adapt_gain: float = 2.0
    tau_adapt_ref: float = 0.25
    tau_scale_min: float = 0.5
    tau_scale_max: float = 2.0


def gumbel_noise(generator: torch.Generator, k: int) -> torch.Tensor:
    """(K,) standard Gumbel draws on the generator's device."""
    u = torch.rand(k, generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


POC_JITTER = 1e-6   # Power-of-Choice's tie-breaking jitter is U[0, POC_JITTER)

# The named (K,) f32 draws a selector can take: "gumbel", standard Gumbel;
# "jitter", uniform in [0, POC_JITTER) (the reference's
# ``uniform(kt, (K,), f32, 0, 1e-6)``, selection.py:194); "remask", the
# standard Gumbel row of the availability re-sample (``fed.availability``;
# the reference's ``gumbel(fold_in(key, 1), (K,))``), drawn only when a run
# has an availability trace; "pool", the standard Gumbel row of the
# ``filtered`` selectors' re-sample inside the pool (the reference's
# ``gumbel(fold_in(key, 1), (K,))`` too, so under an availability trace the
# reference draws one row for both).
DRAW_NAMES = {
    "gumbel": gumbel_noise,
    "jitter": lambda gen, k: POC_JITTER * torch.rand(k, generator=gen, device=gen.device),
    "remask": gumbel_noise,
    "pool": gumbel_noise,
}
# Selectors that take more than the one Gumbel row, and the names they take.
SELECTOR_DRAWS = {"power_of_choice": ("gumbel", "jitter")}


def _is_filtered(name: str) -> bool:
    return name == "filtered" or name.startswith("filtered:")


def selector_draws(name: str) -> Tuple[str, ...]:
    """The names of the draws selector ``name`` takes each round."""
    if _is_filtered(name):
        return ("gumbel", "pool")
    return SELECTOR_DRAWS.get(name, ("gumbel",))


def draw(generator: torch.Generator, names: Tuple[str, ...], k: int) -> Draws:
    """One round's draws from ``generator``: the bare (K,) Gumbel row when
    that is all a selector takes, else a dict of the named rows, drawn in
    the order given."""
    if tuple(names) == ("gumbel",):
        return gumbel_noise(generator, k)
    return {n: DRAW_NAMES[n](generator, k) for n in names}


def named_draw(draws: Draws, name: str) -> torch.Tensor:
    """The row ``name`` of ``draws``; a bare tensor is the Gumbel row."""
    if isinstance(draws, Mapping):
        if name not in draws:
            raise KeyError(f"the selector takes a draw named {name!r}; got "
                           f"{sorted(draws)}")
        return draws[name]
    if name != "gumbel":
        raise ValueError(f"the selector takes a draw named {name!r} besides the "
                         "Gumbel row; pass its draws as a mapping by name")
    return draws


def _topk_first(x: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest entries of the f32 ``x``, largest first, as
    ``jax.lax.top_k`` picks them: by value in IEEE total order (−0.0 below
    +0.0, NaN above +inf; ``score_select.order_keys``), ties to the smaller
    index. ``torch.topk`` does not order ties, and a stable sort of the
    floats ranks −0.0 equal to +0.0."""
    return torch.sort(order_keys(x.to(torch.float32)), descending=True,
                      stable=True).indices[:m]


def dynamic_temperature(round_idx, cfg: SelectorConfig) -> torch.Tensor:
    """τ(t) = τ0 · (1 − 0.5·min(t/100, 1)) as a 0-d f32 CPU tensor."""
    t = torch.tensor(float(round_idx), dtype=torch.float32)
    return cfg.tau0 * (1.0 - 0.5 * torch.clamp_max(t / cfg.tau_decay_rounds, 1.0))


def selection_probabilities(scores: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Eq (12): p_k = softmax(S_k / τ)."""
    return torch.softmax(scores / torch.as_tensor(tau).to(scores.device), dim=0)


def sample_clients(gumbel: torch.Tensor, probs: torch.Tensor, m: int) -> torch.Tensor:
    """m distinct clients ∝ probs via Gumbel-top-m; returns a (K,) bool mask."""
    perturbed = _log(probs + 1e-30) + gumbel.to(probs.device)
    idx = _topk_first(perturbed, m)
    mask = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    mask[idx] = True
    return mask


def heterosel_select(
    gumbel: torch.Tensor,
    state: ClientState,
    round_idx: int,
    *,
    sel_cfg: SelectorConfig,
    score_cfg: HeteRoScoreConfig,
    staleness_override: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HeteRo-Select: Algorithm 1, phases 1–2.

    With ``sel_cfg.use_fused_kernel`` scoring, softmax and Gumbel-top-m run
    through the fused kernels (``kernels.ops.heterosel_topm``); the cohort
    equals the plain branch's for the same noise.
    """
    tau = dynamic_temperature(round_idx, sel_cfg)
    if sel_cfg.use_fused_kernel:
        if not sel_cfg.additive:
            raise ValueError("fused scoring kernel implements the additive form only")
        from repro_torch.kernels import ops as kernel_ops

        selected, probs, _ = kernel_ops.heterosel_topm(
            state, round_idx, tau, sel_cfg.num_selected, gumbel, score_cfg,
            staleness_override=staleness_override)
        mask = torch.zeros(state.num_clients, dtype=torch.bool, device=state.device)
        mask[selected.to(torch.int64)] = True
        return mask, probs
    scores = compute_scores(state, round_idx, score_cfg,
                            additive=sel_cfg.additive,
                            staleness_override=staleness_override)
    probs = selection_probabilities(scores, tau)
    return sample_clients(gumbel, probs, sel_cfg.num_selected), probs


def random_select(gumbel: torch.Tensor, state: ClientState, round_idx: int, *,
                  sel_cfg: SelectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform m-of-K sampling (FedAvg baseline)."""
    k = state.num_clients
    probs = torch.full((k,), 1.0 / k, dtype=torch.float32, device=state.device)
    return sample_clients(gumbel, probs, sel_cfg.num_selected), probs


def power_of_choice_select(draws: Draws, state: ClientState, round_idx: int, *,
                           sel_cfg: SelectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Power-of-Choice [Cho et al. 20]: d uniform candidates, keep the top m
    by local loss (reference ``core/selection.py:173``).

    Draws: ``"gumbel"`` samples the d candidates (``sample_clients`` over
    uniform probs), ``"jitter"`` (U[0, 1e-6)) breaks loss ties, as the two
    halves of the reference's split key do. Unobserved clients get the
    current max loss + 1 (optimistic). ``probs`` is the candidate
    distribution, a diagnostic.
    """
    k = state.num_clients
    m = sel_cfg.num_selected
    d = sel_cfg.poc_candidates or min(2 * m, k)
    dev = state.device
    cand = sample_clients(named_draw(draws, "gumbel"),
                          torch.full((k,), 1.0 / k, dtype=torch.float32, device=dev), d)
    opt_loss = torch.where(state.has_loss > 0, state.loss_prev,
                           torch.max(state.loss_prev) + 1.0)
    jitter = named_draw(draws, "jitter").to(device=dev, dtype=torch.float32)
    cand_loss = torch.where(cand, opt_loss + jitter, -torch.inf)
    mask = torch.zeros(k, dtype=torch.bool, device=dev)
    mask[_topk_first(cand_loss, m)] = True
    return mask, cand.to(torch.float32) / d


def oort_select(draws: Draws, state: ClientState, round_idx: int, *,
                sel_cfg: SelectorConfig, speeds: Optional[torch.Tensor] = None,
                staleness_override: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oort [Lai et al., OSDI 21]: statistical × system utility with an
    explore split (reference ``core/selection.py:202``).

    util_k = loss_k · (1 + c·√min(Δ_k, 100)) · min(1, speed_k)^α, with Δ the
    round-counter staleness or ``staleness_override``; ``speeds`` (K,) are
    T_pref / t_k (omit for a homogeneous fleet). The m − ε·m exploit slots
    are the explored clients with the top utility (ties to the smaller id,
    as the reference's ``top_k``); the ε·m explore slots are drawn with
    ``sample_clients`` over the never-explored clients (over all the rest
    when none is left), from the ``"gumbel"`` draw.
    """
    k = state.num_clients
    m = sel_cfg.num_selected
    m_explore = max(int(round(sel_cfg.oort_explore_frac * m)), 1)
    m_exploit = m - m_explore
    dev = state.device
    if staleness_override is None:
        stale = staleness(state, round_idx).to(torch.float32)
    else:
        stale = torch.clamp_min(staleness_override.to(device=dev, dtype=torch.float32), 0.0)
    util = state.loss_prev * (1.0 + sel_cfg.oort_staleness_coef
                              * torch.sqrt(torch.clamp_max(stale, 100.0)))
    if speeds is not None:
        speeds = torch.as_tensor(speeds).to(device=dev, dtype=torch.float32)
        util = util * torch.clamp_max(speeds, 1.0) ** sel_cfg.oort_system_alpha
    explored = state.has_loss > 0
    exploit_util = torch.where(explored, util, -torch.inf)
    mask = torch.zeros(k, dtype=torch.bool, device=dev)
    mask[_topk_first(exploit_util, m_exploit)] = True
    unexplored = ~explored & ~mask
    w = torch.where(unexplored, 1.0,
                    torch.where(unexplored.any(), 0.0, (~mask).to(torch.float32)))
    w = w / torch.clamp_min(torch.sum(w), 1e-9)
    mask = mask | sample_clients(named_draw(draws, "gumbel"), w, m_explore)
    probs = torch.softmax(torch.where(torch.isfinite(exploit_util), exploit_util, -1e9),
                          dim=0)
    return mask, probs


def heterogeneity_scale(state: ClientState, sel_cfg: SelectorConfig) -> torch.Tensor:
    """Temperature rescale from the observed-loss coefficient of variation
    (reference ``core/selection.py:333``).

    cv = std/mean over the clients with an observed loss; scale =
    clip(1 + gain·(cv − ref), scale_min, scale_max). No observation yet ⇒
    cv := ref ⇒ scale 1. A pure function of the ``ClientState``, so the
    selector needs no controller state of its own.
    """
    obs = (state.has_loss > 0).to(torch.float32)
    loss = state.loss_prev.to(torch.float32)
    n = torch.sum(obs)
    mean = torch.sum(loss * obs) / torch.clamp_min(n, 1.0)
    var = torch.sum(obs * (loss - mean) ** 2) / torch.clamp_min(n, 1.0)
    cv = torch.sqrt(var) / torch.clamp_min(torch.abs(mean), 1e-6)
    cv = torch.where(n > 0, cv, sel_cfg.tau_adapt_ref)
    scale = 1.0 + sel_cfg.tau_adapt_gain * (cv - sel_cfg.tau_adapt_ref)
    return torch.clamp(scale, sel_cfg.tau_scale_min, sel_cfg.tau_scale_max)


def adaptive_select(
    gumbel: torch.Tensor,
    state: ClientState,
    round_idx: int,
    *,
    sel_cfg: SelectorConfig,
    score_cfg: HeteRoScoreConfig,
    staleness_override: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HeteRo scoring with a heterogeneity-adaptive softmax temperature
    (reference ``core/selection.py:352``): a wide loss spread gives a hotter
    softmax (broader exploration), equal losses a cooler one."""
    tau = (dynamic_temperature(round_idx, sel_cfg).to(state.device)
           * heterogeneity_scale(state, sel_cfg))
    scores = compute_scores(state, round_idx, score_cfg, additive=sel_cfg.additive,
                            staleness_override=staleness_override)
    probs = selection_probabilities(scores, tau)
    return sample_clients(gumbel, probs, sel_cfg.num_selected), probs


# ---------------------------------------------------------------------------
# FilFL-style pre-selection filtering (arXiv:2302.06599)
# ---------------------------------------------------------------------------


def filter_pool_size(num_clients: int, sel_cfg: SelectorConfig) -> int:
    """Static pool size: ceil(keep_frac·K), never below m, never above K."""
    n_keep = math.ceil(sel_cfg.filter_keep_frac * num_clients)
    return min(max(n_keep, sel_cfg.num_selected), num_clients)


def filter_pool(state: ClientState, sel_cfg: SelectorConfig) -> torch.Tensor:
    """(K,) bool — the surviving candidate pool (reference
    ``core/selection.py:256``).

    Utility is the optimistic local loss (unobserved clients get max + 1, so
    exploration is never filtered away) plus ``filter_diversity_coef`` × the
    label divergence; the top ``filter_pool_size`` by utility survive, ties
    to the smaller id. Deterministic given the state.
    """
    n_keep = filter_pool_size(state.num_clients, sel_cfg)
    opt_loss = torch.where(state.has_loss > 0, state.loss_prev,
                           torch.max(state.loss_prev) + 1.0)
    util = opt_loss + sel_cfg.filter_diversity_coef * state.label_js
    pool = torch.zeros(state.num_clients, dtype=torch.bool, device=state.device)
    pool[_topk_first(util, n_keep)] = True
    return pool


def pool_resample(gumbel: torch.Tensor, probs: torch.Tensor, pool: torch.Tensor,
                  m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Renormalize ``probs`` onto ``pool`` and Gumbel-top-m sample inside it
    (reference ``_pool_resample``, :275).

    Pruned clients get a hard −inf perturbed score (a probability floor is
    not enough: softmax underflow plus Gumbel ties could leak one through
    the top-m). The pool holds ≥ m members, so exactly m pool clients are
    selected. ``gumbel`` is the ``"pool"`` draw.
    """
    probs = torch.where(pool, probs, 0.0)
    norm = torch.sum(probs)
    uniform_pool = pool.to(probs.dtype) / torch.clamp_min(torch.sum(pool), 1)
    probs = torch.where(norm > 1e-9, probs / torch.clamp_min(norm, 1e-9), uniform_pool)
    perturbed = torch.where(pool, _log(probs + 1e-30) + gumbel.to(probs.device), -torch.inf)
    mask = torch.zeros_like(pool)
    mask[_topk_first(perturbed, m)] = True
    return mask & pool, probs


# Scoring bases the filtering stage composes with. power_of_choice is
# excluded: its ``probs`` are a candidate-set diagnostic, not a scoring
# distribution to renormalize. heterosel_pallas is excluded because the
# fused kernel samples in-kernel: filtering would discard its cohort and
# re-sample on the host.
FILTER_BASES = ("heterosel", "heterosel_mult", "random", "oort")


def base_selector_name(name: str) -> str:
    """'filtered:<base>' → '<base>'; 'filtered' → 'heterosel'; else name.

    The hierarchical engine takes the outer stage's semantics (uniform or
    pooled HeteRo scoring) from it for composite names.
    """
    if name == "filtered":
        return "heterosel"
    if name.startswith("filtered:"):
        return name.split(":", 1)[1]
    return name


def _filter_base(name: str) -> str:
    base = base_selector_name(name)
    if base not in FILTER_BASES:
        raise ValueError(
            f"filtered selector cannot wrap '{base}': valid bases are {FILTER_BASES}")
    return base


def edge_selection_probs(pooled_state: ClientState, round_idx,
                         sel_cfg: SelectorConfig,
                         score_cfg: HeteRoScoreConfig) -> torch.Tensor:
    """(E,) cross-edge selection probabilities for the hierarchical outer
    stage: Eqs 1–12 on the pooled pseudo-client state
    (``core.state.pool_client_state``). Sampling stays with the caller,
    which masks busy edges before its Gumbel-top-m draw."""
    scores = compute_scores(pooled_state, round_idx, score_cfg,
                            additive=sel_cfg.additive)
    return selection_probabilities(scores, dynamic_temperature(round_idx, sel_cfg))


# Names make_selector serves, the reference's: the paper's five (Table I),
# the fused-kernel heterosel, 'filtered' (plus 'filtered:<base>') and
# 'adaptive'.
SELECTORS = ("heterosel", "heterosel_pallas", "heterosel_mult", "random",
             "power_of_choice", "oort", "filtered", "adaptive")


def _unknown(name: str) -> ValueError:
    return ValueError(f"unknown selector '{name}': valid names are {SELECTORS} "
                      f"(plus 'filtered:<base>' for base in {FILTER_BASES})")


def make_selector(name: str, sel_cfg: SelectorConfig,
                  score_cfg: HeteRoScoreConfig | None = None, *,
                  speeds: Optional[torch.Tensor] = None) -> SelectFn:
    """Factory over ``SELECTORS``. ``heterosel_pallas`` is the name the
    reference gives its fused-kernel branch; here it runs the CUDA kernels.
    ``'filtered'`` wraps heterosel and ``'filtered:<base>'`` any name in
    ``FILTER_BASES``: the base's probabilities are renormalized onto the
    surviving pool and the cohort drawn inside it from the ``"pool"`` row
    (the base's own cohort, from the ``"gumbel"`` row, is discarded).
    ``speeds`` (K,) enables Oort's system-utility term."""
    score_cfg = score_cfg or HeteRoScoreConfig()
    if _is_filtered(name):
        base = make_selector(_filter_base(name), sel_cfg, score_cfg, speeds=speeds)

        def filtered(draws, state, round_idx):
            _, probs = base(named_draw(draws, "gumbel"), state, round_idx)
            return pool_resample(named_draw(draws, "pool"), probs,
                                 filter_pool(state, sel_cfg), sel_cfg.num_selected)

        return filtered
    if name == "heterosel":
        return functools.partial(heterosel_select, sel_cfg=sel_cfg, score_cfg=score_cfg)
    if name == "heterosel_pallas":
        fused = dataclasses.replace(sel_cfg, use_fused_kernel=True, additive=True)
        return functools.partial(heterosel_select, sel_cfg=fused, score_cfg=score_cfg)
    if name == "heterosel_mult":
        mult = dataclasses.replace(sel_cfg, additive=False)
        return functools.partial(heterosel_select, sel_cfg=mult, score_cfg=score_cfg)
    if name == "random":
        return functools.partial(random_select, sel_cfg=sel_cfg)
    if name == "power_of_choice":
        return functools.partial(power_of_choice_select, sel_cfg=sel_cfg)
    if name == "oort":
        return functools.partial(oort_select, sel_cfg=sel_cfg, speeds=speeds)
    if name == "adaptive":
        return functools.partial(adaptive_select, sel_cfg=sel_cfg, score_cfg=score_cfg)
    raise _unknown(name)


def make_async_selector(name: str, sel_cfg: SelectorConfig,
                        score_cfg: HeteRoScoreConfig | None = None, *,
                        speeds: Optional[torch.Tensor] = None) -> AsyncSelectFn:
    """Factory for the 4-argument selectors ``(draws, state, round_idx,
    staleness)`` of the asynchronous engine (reference
    ``core/selection.py:451``).

    ``staleness`` is the (K,) f32 clock-measured staleness: elapsed virtual
    time since each client's update was last aggregated, in reference round
    durations. HeteRo-Select's freshness term (Eq 7) and Oort's staleness
    term read it instead of the round counter; ``heterosel_pallas`` hands it
    to K1 + K2 as the override row (``kernels.ops.heterosel_topm``, the
    kernel's ``use_ov``). ``random`` and ``power_of_choice`` have no
    freshness term and ignore it. ``filtered`` hands it to its base for
    scoring; the pool itself depends only on the staleness-free utility.
    """
    score_cfg = score_cfg or HeteRoScoreConfig()
    if _is_filtered(name):
        base = make_async_selector(_filter_base(name), sel_cfg, score_cfg, speeds=speeds)

        def filtered_async(draws, state, round_idx, stale):
            _, probs = base(named_draw(draws, "gumbel"), state, round_idx, stale)
            return pool_resample(named_draw(draws, "pool"), probs,
                                 filter_pool(state, sel_cfg), sel_cfg.num_selected)

        return filtered_async
    if name in ("heterosel", "heterosel_mult", "heterosel_pallas", "adaptive"):
        base = make_selector(name, sel_cfg, score_cfg)

        def scored_async(draws, state, round_idx, stale):
            return base(draws, state, round_idx, staleness_override=stale)

        return scored_async
    if name == "oort":

        def oort_async(draws, state, round_idx, stale):
            return oort_select(draws, state, round_idx, sel_cfg=sel_cfg, speeds=speeds,
                               staleness_override=stale)

        return oort_async
    if name in ("random", "power_of_choice"):
        base = make_selector(name, sel_cfg, score_cfg)

        def stateless_async(draws, state, round_idx, stale):
            return base(draws, state, round_idx)

        return stateless_async
    raise _unknown(name)
