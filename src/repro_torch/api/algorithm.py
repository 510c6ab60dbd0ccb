"""Sampling algorithms as ``(init, step)`` pairs over chain-batched state.

Port of :mod:`repro.api.algorithm`. :func:`firefly` builds the exact-subset
chain, :func:`regular_mcmc` the full-data baseline; both return a
:class:`SamplingAlgorithm` whose ``step`` emits
:class:`~repro_torch.core.flymc.StepStats`, so the driver treats them alike.
The chain axis is explicit: ``init(keys (K, 2), positions (K, ...))`` and
``step(keys (K, 2), state)`` advance all K chains at once — there is no
``vmap``, and each kernel launches once per step for all chains.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import bounds as bounds_lib
from repro_torch.core import flymc, samplers
from repro_torch.core.bounds import CollapsedStats, GLMData
from repro_torch.core.flymc import FlyMCSpec, StepStats
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplingAlgorithm:
    """init(keys, positions) -> state; step(keys, state) -> (state, stats).

    ``grow``/``resize``/``init_overflow`` exist for algorithms with bounded
    buffers (FlyMC's capacities): ``grow()`` is the same algorithm with
    doubled capacities, ``resize(state)`` reshapes a state for them without
    likelihood queries, ``init_overflow(state)`` flags a (K,) initial state
    that does not fit.

    ``step_data(keys, state, data, stats)`` is ``step`` with the dataset
    and its sufficient statistics passed in rather than closed over, and
    ``data``/``stats`` are the ones ``step`` closes over. The serve group
    engines run one spec over many lanes' datasets through it. The
    reference threads data as an operand because XLA rounds a baked-in
    dataset differently; eager PyTorch has no such constant folding, and
    the operand form gives the closure form's bits (pinned in
    ``tests/test_torch_collectors.py``). ``step_chains_data`` is the
    reference's chain-batched operand form; the port's ``step`` is already
    chain-batched, so it is the same callable as ``step_data``.

    ``local_chains(num_chains)`` makes the driver step only those rows of
    a run's chains (their keys and initial positions), the rest being
    another process's: what a chain fleet over ranks needs.
    """

    init: Callable[[torch.Tensor, Any], Any]
    step: Callable[[torch.Tensor, Any], tuple[Any, StepStats]]
    device: torch.device
    grow: Callable[[], "SamplingAlgorithm"] | None = None
    resize: Callable[[Any], Any] | None = None
    init_overflow: Callable[[Any], torch.Tensor] | None = None
    default_position: Any = None
    spec: Any = None
    step_data: Callable[..., tuple[Any, StepStats]] | None = None
    step_chains_data: Callable[..., tuple[Any, StepStats]] | None = None
    data: Any = None
    stats: Any = None
    # The chain rows this process steps, of a run's num_chains (a chain
    # fleet's share, :func:`repro_torch.distributed.flymc_dist.chain_fleet`);
    # None steps them all.
    local_chains: Callable[[int], slice] | None = None

    def position_of(self, state) -> torch.Tensor:
        return state.sampler.theta

    def output_structs(self, state):
        """Zero tensors shaped like one step's outputs, with no step run:
        ``(position (K, ...), StepStats of (K,) leaves)`` with the dtypes
        ``step`` emits (counts int64, ``overflow`` bool, the rest the
        log-density's float). What collectors size their carries from
        before the first chunk (the reference's ``jax.eval_shape``)."""
        lp = state.sampler.lp
        count = torch.zeros(lp.shape, dtype=torch.int64, device=lp.device)
        return (torch.zeros_like(self.position_of(state)),
                StepStats(n_bright=count, lik_queries=count.clone(),
                          accept_prob=torch.zeros_like(lp),
                          overflow=torch.zeros(lp.shape, dtype=torch.bool,
                                               device=lp.device),
                          joint_lp=torch.zeros_like(lp)))


def firefly(
    model=None,
    *,
    bound=None,
    log_prior=None,
    data: GLMData | None = None,
    stats: CollapsedStats | None = None,
    kernel: str = "rwmh",
    capacity: int = 1024,
    cand_capacity: int = 1024,
    q_db: float = 0.01,
    mode: str = "implicit",
    resample_fraction: float = 0.1,
    step_size: float = 0.1,
    adapt_target: float | str | None = None,
    num_warmup: int = 1000,
    kernel_params=(),
    backend: str = "pallas",
    z_backend: str = "fused",
    device="cuda",
) -> SamplingAlgorithm:
    """Build the FlyMC sampling algorithm (paper §2–3).

    ``model`` carries ``.bound/.log_prior/.data`` (and optionally
    ``.stats``), e.g. :class:`repro_torch.models.bayes_glm.GLMModel`.
    ``kernel`` names a θ-kernel ("rwmh", "mala", "slice", "hmc").
    ``adapt_target="auto"`` adapts the step size toward the kernel's
    standard accept rate during the first ``num_warmup`` iterations only.

    The engines default to the two kernels, the port's path on the card:
    ``backend="pallas"`` (the fused bright-GLM kernel; the bound needs a
    fused family) and ``z_backend="fused"`` (the streamed candidate kernel).
    The reference defaults to ``backend="jnp", z_backend="jnp"``, the plain
    engines, which take any bound: pass both for the reference's default
    chain. ``mode="explicit"`` (Algorithm 1, resampling a random
    ``resample_fraction`` of z each step) needs ``z_backend="jnp"``.
    """
    dev = resolve_device(device)
    if model is not None:
        bound = bound if bound is not None else model.bound
        log_prior = log_prior if log_prior is not None else model.log_prior
        data = data if data is not None else model.data
        stats = stats if stats is not None else getattr(model, "stats", None)
    if data is None or log_prior is None or bound is None:
        raise ValueError("firefly() needs a model, or explicit bound=, log_prior=, data=")
    if data.x.device != dev:
        raise ValueError(f"data is on {data.x.device}, but device={dev}")
    bound = bounds_lib.get_bound(bound)
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}; expected 'jnp' or 'pallas'")
    if backend == "pallas" and bounds_lib.fused_family_of(bound) is None:
        raise ValueError(
            f"backend='pallas' needs a FusedBound; {type(bound).__name__} "
            "has no usable fused_family hook (backend='jnp' takes any bound)"
        )
    if z_backend not in ("jnp", "fused"):
        raise ValueError(
            f"unknown z_backend {z_backend!r}; expected 'jnp' or 'fused'")
    if z_backend == "fused" and mode != "implicit":
        raise ValueError(
            "z_backend='fused' requires mode='implicit' (the fused engine "
            "streams Algorithm 2's sparse dark→bright candidate proposals; "
            "Algorithm 1's explicit Gibbs resampling has no such stream)"
        )
    if stats is None:
        stats = bound.suffstats(data)
    ks = samplers.get_kernel(kernel)
    if adapt_target == "auto":
        adapt_target = None if ks.target_accept >= 1.0 else ks.target_accept
    n = data.x.shape[0]
    spec = FlyMCSpec(
        bound=bound, log_prior=log_prior, kernel=kernel,
        capacity=min(int(capacity), n), cand_capacity=min(int(cand_capacity), n),
        q_db=q_db, mode=mode, resample_fraction=resample_fraction,
        kernel_kwargs=tuple(kernel_params), adapt_target=adapt_target,
        backend=backend, z_backend=z_backend, num_warmup=int(num_warmup),
    )
    return _firefly_from_spec(spec, data, stats, step_size)


def _firefly_from_spec(spec: FlyMCSpec, data: GLMData, stats: CollapsedStats,
                       step_size: float) -> SamplingAlgorithm:
    n = data.x.shape[0]

    def init(keys, positions):
        return flymc.init_chain_state(spec, data, stats, positions, keys,
                                      step_size=step_size)

    def step_data(keys, state, data_, stats_):
        # The operand form the serve group engines run (one spec, each
        # lane's own dataset). The chain state's rng slot is overwritten with
        # the driver's keys so the step is a pure function of its operands.
        return flymc.flymc_step(spec, data_, stats_, state._replace(rng=keys))

    def step(keys, state):
        return step_data(keys, state, data, stats)

    grown = []

    def grow():
        if not grown:
            grown.append(_firefly_from_spec(flymc._grow(spec, n), data, stats,
                                            step_size))
        return grown[0]

    def resize(state):
        return flymc.resize_state(spec, state)

    def init_overflow(state):
        return state.bright.num > spec.capacity

    d = data.x.shape[-1]
    dev = data.x.device
    if isinstance(spec.bound, bounds_lib.SoftmaxBound):
        default_position = torch.zeros(data.xi.shape[-1], d, device=dev)
    else:
        default_position = torch.zeros(d, device=dev)
    can_grow = spec.capacity < n or spec.cand_capacity < n
    return SamplingAlgorithm(
        init=init, step=step, device=dev, grow=grow if can_grow else None,
        resize=resize, init_overflow=init_overflow,
        default_position=default_position, spec=spec,
        step_data=step_data, step_chains_data=step_data, data=data,
        stats=stats,
    )


def algorithm_from_spec(spec: FlyMCSpec, data: GLMData, stats: CollapsedStats,
                        step_size: float = 0.1) -> SamplingAlgorithm:
    """Wrap a :class:`FlyMCSpec` as a SamplingAlgorithm on the data's
    device."""
    return _firefly_from_spec(spec, data, stats, step_size)


# ---------------------------------------------------------------------------
# Full-data baseline
# ---------------------------------------------------------------------------


class MCMCState(NamedTuple):
    sampler: samplers.SamplerState
    log_step: torch.Tensor  # (K,)
    iteration: torch.Tensor  # (K,) int64


def regular_mcmc(
    model=None,
    *,
    logdensity_fn=None,
    n_data: int | None = None,
    kernel: str = "rwmh",
    step_size: float = 0.1,
    adapt_target: float | str | None = None,
    num_warmup: int = 1000,
    kernel_params=(),
    theta_shape=None,
    device="cuda",
) -> SamplingAlgorithm:
    """Full-data MCMC baseline: every density evaluation costs N queries.

    ``model`` supplies the exact log posterior, or pass ``logdensity_fn``
    (θ (K, ...) -> (lp (K,), aux)) and ``n_data``. Emits the same StepStats
    as :func:`firefly` (``overflow`` always False, ``n_bright`` = N).
    """
    dev = resolve_device(device)
    if model is not None:
        logdensity_fn = logdensity_fn or model.full_logpdf_fn()
        n_data = n_data if n_data is not None else model.data.x.shape[0]
        theta_shape = theta_shape or model.theta_shape
    if logdensity_fn is None or n_data is None:
        raise ValueError("regular_mcmc() needs a model or logdensity_fn + n_data")
    ks = samplers.get_kernel(kernel)
    if adapt_target == "auto":
        adapt_target = None if ks.target_accept >= 1.0 else ks.target_accept
    kern = samplers.bind(kernel, logdensity_fn, kernel_params)

    def init(keys, positions):
        del keys
        st = samplers.init_state(logdensity_fn, positions, with_grad=ks.needs_grad)
        k = positions.shape[0]
        return MCMCState(
            sampler=st,
            log_step=torch.log(torch.full((k,), step_size, dtype=st.lp.dtype,
                                          device=dev)),
            iteration=torch.zeros(k, dtype=torch.int64, device=dev),
        )

    def step(keys, state):
        new, info = kern(keys, state.sampler, torch.exp(state.log_step))
        log_step = state.log_step
        if adapt_target is not None:
            adapted = samplers.adapt_step_size(
                log_step, info.accept_prob, adapt_target, state.iteration
            )
            log_step = torch.where(state.iteration < num_warmup, adapted, log_step)
        n = torch.full_like(state.iteration, n_data)
        stats = StepStats(
            n_bright=n,
            lik_queries=info.n_evals * n,
            accept_prob=info.accept_prob,
            overflow=torch.zeros_like(info.accepted),
            joint_lp=new.lp,
        )
        return MCMCState(new, log_step, state.iteration + 1), stats

    default_position = (
        torch.zeros(theta_shape, device=dev) if theta_shape is not None else None
    )
    return SamplingAlgorithm(init=init, step=step, device=dev,
                             default_position=default_position)
