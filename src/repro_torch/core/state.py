"""Per-client metadata tracked by the server across federated rounds.

Struct-of-arrays as in ``repro.core.state``: every field is a ``(K,)``
tensor on the run's device, so scoring is one vectorized pass and the fused
kernel (``kernels.score_select``) reads the fields without a gather.
Functions return new states; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
import torch

# Sentinel for "never selected" — keeps staleness = t - last_selected large.
NEVER = -(10**6)


@dataclasses.dataclass(frozen=True)
class ClientState:
    """Server-side per-client metadata, all ``(K,)`` float32/int32 tensors.

    Attributes:
      loss_prev:     L_k(w_{t-1}) — latest observed local loss per client.
      loss_prev2:    L_k(w_{t-2}) — the loss one observation earlier.
      label_js:      JS(P_k || P_avg) per client (static under fixed data).
      part_count:    h_k — number of times client k has participated (int32).
      last_selected: l_k — last round client k was selected (int32, NEVER).
      update_sqnorm: ||w_k^{t'} - w_{t'-1}||^2 from client k's last update.
      has_loss:      1.0 once a loss observation exists.
      has_momentum:  1.0 once two observations exist.
    """

    loss_prev: torch.Tensor
    loss_prev2: torch.Tensor
    label_js: torch.Tensor
    part_count: torch.Tensor
    last_selected: torch.Tensor
    update_sqnorm: torch.Tensor
    has_loss: torch.Tensor
    has_momentum: torch.Tensor

    @property
    def num_clients(self) -> int:
        return self.loss_prev.shape[0]

    @property
    def device(self) -> torch.device:
        return self.loss_prev.device

    def map(self, fn) -> "ClientState":
        """A state with ``fn`` applied to every field."""
        return ClientState(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def init_client_state(num_clients: int, label_js=None, *,
                      device: str | torch.device = "cuda") -> ClientState:
    """Fresh state at round 0. ``label_js`` comes from fed.partition."""
    k = num_clients
    f32 = dict(dtype=torch.float32, device=device)
    if label_js is None:
        js = torch.zeros(k, **f32)
    else:
        js = torch.as_tensor(label_js).to(**f32)
    return ClientState(
        loss_prev=torch.zeros(k, **f32),
        loss_prev2=torch.zeros(k, **f32),
        label_js=js,
        part_count=torch.zeros(k, dtype=torch.int32, device=device),
        last_selected=torch.full((k,), NEVER, dtype=torch.int32, device=device),
        update_sqnorm=torch.zeros(k, **f32),
        has_loss=torch.zeros(k, **f32),
        has_momentum=torch.zeros(k, **f32),
    )


def update_client_state(
    state: ClientState,
    *,
    round_idx: int,
    selected_mask: torch.Tensor,
    observed_loss: torch.Tensor,
    observed_sqnorm: torch.Tensor,
) -> ClientState:
    """Fold one round's observations into the metadata (Algorithm 1, line 24).

    Dtype-preserving: a bf16 state stays bf16 — fresh f32 observations are
    cast down at the write.
    """
    sel = selected_mask.to(torch.bool)
    self_f = sel.to(state.has_loss.dtype)
    new_loss_prev2 = torch.where(sel, state.loss_prev, state.loss_prev2)
    new_loss_prev = torch.where(sel, observed_loss, state.loss_prev)
    new_has_momentum = torch.where(sel & (state.has_loss > 0), 1.0,
                                   state.has_momentum)
    return ClientState(
        loss_prev=new_loss_prev.to(state.loss_prev.dtype),
        loss_prev2=new_loss_prev2.to(state.loss_prev2.dtype),
        label_js=state.label_js,
        part_count=state.part_count + sel.to(torch.int32),
        last_selected=torch.where(
            sel, torch.tensor(round_idx, dtype=torch.int32, device=sel.device),
            state.last_selected),
        update_sqnorm=torch.where(sel, observed_sqnorm, state.update_sqnorm
                                  ).to(state.update_sqnorm.dtype),
        has_loss=torch.maximum(state.has_loss, self_f),
        has_momentum=new_has_momentum.to(state.has_momentum.dtype),
    )


def to_bf16(state: ClientState) -> ClientState:
    """Compact the float fields to bf16; the int32 counters stay exact."""
    return state.map(
        lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x)


def to_f32(state: ClientState) -> ClientState:
    """Upcast a bf16-compacted state back to f32 (no-op on f32 states)."""
    return state.map(
        lambda x: x.to(torch.float32) if x.dtype == torch.bfloat16 else x)


def field_dtypes(state: ClientState) -> dict[str, torch.dtype]:
    return {f.name: getattr(state, f.name).dtype
            for f in dataclasses.fields(state)}


def staleness(state: ClientState, round_idx: int) -> torch.Tensor:
    """Δ_k = t - l_k, clipped to ≥0 (never-selected clients get huge Δ)."""
    return torch.clamp_min(round_idx - state.last_selected, 0)


def scatter_observations(
    num_clients: int,
    selected_idx: torch.Tensor,
    mean_loss: torch.Tensor,
    update_sqnorm: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (K,) observation tensors from the batched cohort's (M,) results.

    Non-selected slots read 0 and are masked out by ``update_client_state``.
    """
    dev = mean_loss.device
    idx = torch.as_tensor(selected_idx, dtype=torch.int64, device=dev)
    loss = torch.zeros(num_clients, dtype=torch.float32, device=dev)
    sq = torch.zeros(num_clients, dtype=torch.float32, device=dev)
    loss[idx] = mean_loss.to(torch.float32)
    sq[idx] = update_sqnorm.to(torch.float32)
    return loss, sq


def pool_client_state(state: ClientState, assignment: torch.Tensor,
                      num_edges: int) -> ClientState:
    """(E,)-pooled ``ClientState`` for the hierarchical outer stage.

    Each edge becomes one pseudo-client whose metadata pools its members'
    rows, so the scoring runs unchanged on the result:

      * ``loss_prev`` / ``loss_prev2`` / ``update_sqnorm`` — mean over the
        edge's observed members (``has_loss`` / ``has_momentum``-weighted);
      * ``label_js`` and ``part_count`` — plain mean (f32);
      * ``last_selected`` — max (the edge's most recent contact, int32);
      * ``has_loss`` / ``has_momentum`` — max (any member observed).

    ``assignment`` is the (K,) edge id of each client. Sums are
    ``index_add_`` and maxima ``scatter_reduce(..., "amax")``: one O(K) pass
    each, no per-edge gathers.
    """
    seg = torch.as_tensor(assignment).to(device=state.device, dtype=torch.int64)

    def ssum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(num_edges, dtype=torch.float32, device=x.device)
        return out.index_add_(0, seg, x.to(torch.float32))

    def smax(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(num_edges, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, seg, x, "amax", include_self=False)

    counts = torch.clamp_min(ssum(torch.ones_like(state.has_loss)), 1.0)
    n_obs = torch.clamp_min(ssum(state.has_loss), 1.0)
    n_mom = torch.clamp_min(ssum(state.has_momentum), 1.0)
    return ClientState(
        loss_prev=ssum(state.loss_prev * state.has_loss) / n_obs,
        loss_prev2=ssum(state.loss_prev2 * state.has_momentum) / n_mom,
        label_js=ssum(state.label_js) / counts,
        part_count=ssum(state.part_count) / counts,
        last_selected=smax(state.last_selected),
        update_sqnorm=ssum(state.update_sqnorm * state.has_loss) / n_obs,
        has_loss=smax(state.has_loss),
        has_momentum=smax(state.has_momentum),
    )


def score_inputs(state: ClientState) -> tuple[torch.Tensor, ...]:
    """The eight (K,) metadata vectors in the fused kernel's argument order."""
    return (
        state.loss_prev,
        state.loss_prev2,
        state.label_js,
        state.part_count,
        state.last_selected,
        state.update_sqnorm,
        state.has_loss,
        state.has_momentum,
    )
