"""GroupEngine: one batching group's jobs, each a lane, stepped together.

Port of :mod:`repro.serve.engine`. One engine owns every admitted job of
one :func:`repro_torch.serve.job.group_key`. A **lane** is one whole job:
its K chains on the chain axis, its own dataset and sufficient statistics.
A chunk advances every lane ``chunk_size`` steps, jobs at different
progress points each following exactly its solo trajectory.

Exactness contract (pinned in ``tests/test_torch_serve.py``): every job's
trajectory and collector results are bitwise the solo
``api.sample(build_algorithm(job), key(job.seed), max_samples,
num_chains=K)`` run, whoever shares the group, whenever the job joined or
left and however often the group grew. What carries it:

  * **Lane-local compute.** The ``"map"`` lane backend (the default) is a
    Python loop over the lanes. Each lane's K chains are stepped by the
    same chain-batched ``flymc_step`` call a solo
    ``api.sample(num_chains=K)`` makes, through the algorithm's operand
    form ``step_data(keys, state, data, stats)`` with the lane's own
    dataset. The ``"vmap"`` backend stacks the L lanes into one
    chain-batched call of L·K chains on a lane stack of the datasets
    (``data`` leaves ``(L, N, ...)``): each kernel launches once a group
    step instead of once a lane-step. A chain's arithmetic does not depend
    on the chains beside it (both kernels take the lane axis, and the
    step's other reductions are ``tree_sum`` and elementwise products), so
    under either backend nothing a lane computes depends on its
    neighbours, and ``"vmap"`` is bitwise ``"map"``. (The reference's
    ``"vmap"`` is not: XLA's rounding there follows the batch width.)
  * **Keys come from the state, not the schedule.** Each step keys with
    ``fold_in(chain_keys, state.iteration)``, the driver's
    ``fold_in(chain_key, i)`` at whatever iteration the lane has reached.
    The iteration is read on the device: no host wait.
  * **Admission copies the driver's init** through
    :func:`repro_torch.serve.job.chain_rows`.
  * **Capacity is a group property.** Members run at one (capacity,
    cand_capacity); an overflow on a healthy lane doubles the group
    (clamped to N) and re-runs the chunk from the saved pre-chunk states. A
    new member whose initial bright set does not fit grows the group at
    admission. Chains are bitwise capacity-invariant, so neither perturbs
    anyone.
  * **Folds skip a job's overshoot** (:func:`repro_torch.api.driver.
    make_collector_fold` with ``max_count``), so carries equal the solo
    run's.

Group state is a Python list of per-lane dicts (state, chain keys, data,
stats, carries, folded count) in membership order, not stacked
``(L, ...)`` tensors: admission and eviction are list operations that copy
no device memory. The ``"vmap"`` backend concatenates the lanes' states,
keys, datasets and statistics at the start of a chunk attempt and splits
the result at its end (a copy of the chains' state and the datasets, once
a chunk of many steps); a group of one lane runs on views of its own. The folds stay a per-lane loop under both backends. The
reference pads the lane axis to a power-of-2 bucket so that join and leave
recompile O(log L) times; nothing here is compiled, so the engine runs no
pad lane and :func:`bucket_size` pads nothing. Nothing is compiled either
for the chunk or the fold, so there is no counterpart of the reference's
``driver.cached_jit`` cache.
"""

from __future__ import annotations

import torch

from repro_torch.api import collectors as collectors_lib
from repro_torch.api import driver
from repro_torch.core.bounds import CollapsedStats, GLMData
from repro_torch.core.flymc import StepStats
from repro_torch.serve import job as job_lib

LANE_BACKENDS = ("map", "vmap")


def check_lane_backend(lane_backend: str) -> None:
    if lane_backend not in LANE_BACKENDS:
        raise ValueError(f"unknown lane_backend {lane_backend!r}")


def _cat(trees):
    """Per-leaf concatenation along the chain axis of same-shaped
    (nested NamedTuple) states or tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    return type(first)(*(_cat([t[i] for t in trees])
                         for i in range(len(first))))


def _rows(tree, a: int, b: int):
    """Chains ``a:b`` of every leaf."""
    if isinstance(tree, torch.Tensor):
        return tree[a:b]
    return type(tree)(*(_rows(t, a, b) for t in tree))


def _by_lane(a: torch.Tensor, lanes: int, axis: int = 0) -> torch.Tensor:
    """A lane-major chain axis ``axis`` split into ``(lanes, K)``."""
    return a.reshape(a.shape[:axis] + (lanes, -1) + a.shape[axis + 1:])


def bucket_size(n: int) -> int:
    """The next power of two ≥ n (≥ 1): the reference's lane-axis padding.
    Kept for its callers; the port's engines compile nothing and pad no
    lane."""
    b = 1
    while b < n:
        b *= 2
    return b


class GroupEngine:
    """The lanes of one group key. See the module docstring.

    ``template`` is any member job: it supplies the spec and the collector
    instances (the group key pins both). Counters for accounting:
    ``lane_steps`` (one step of one lane's K chains, overflow re-runs
    included), ``group_steps`` (chain-batched ``flymc_step`` calls: one a
    lane-step under ``"map"``, one a step of every lane under ``"vmap"``),
    ``inits`` (lane initializations, growth re-inits included), ``chunks``,
    ``reruns`` and ``waits`` (host reads in ``run_chunk``).
    """

    def __init__(self, template: job_lib.Job, capacity: int | None = None,
                 cand_capacity: int | None = None,
                 lane_backend: str = "map"):
        check_lane_backend(lane_backend)
        self.group_key = job_lib.group_key(template)
        self.template = template
        self.num_chains = template.num_chains
        self.max_samples = template.policy.max_samples
        self.lane_backend = lane_backend
        self.colls = collectors_lib.validate_collectors(template.collectors)
        self._alg = job_lib.build_algorithm(
            template,
            capacity=template.capacity if capacity is None else capacity,
            cand_capacity=(template.cand_capacity if cand_capacity is None
                           else cand_capacity),
        )
        self._n = template.data.x.shape[0]
        self.device = template.device
        self._lanes: list[dict] = []  # membership order
        self._jobs: dict[str, job_lib.Job] = {}
        self._quarantined: list[str] = []
        self.lane_steps = self.inits = self.chunks = self.reruns = 0
        self.group_steps = self.waits = 0

    # ------------------------------------------------------------ geometry

    @property
    def capacity(self) -> int:
        return self._alg.spec.capacity

    @property
    def cand_capacity(self) -> int:
        return self._alg.spec.cand_capacity

    @property
    def num_slots(self) -> int:
        """Budgeted chain slots: lanes × chains."""
        return len(self._lanes) * self.num_chains

    @property
    def job_ids(self) -> list[str]:
        return [lane["job_id"] for lane in self._lanes]

    def job(self, job_id: str) -> job_lib.Job:
        return self._jobs[job_id]

    def _lane_index(self, job_id: str) -> int:
        for i, lane in enumerate(self._lanes):
            if lane["job_id"] == job_id:
                return i
        raise KeyError(f"job {job_id!r} is not in this group")

    # ------------------------------------------------------------ capacity

    def _grow(self):
        """Double the group capacities (clamped to N)."""
        if self._alg.grow is None:
            raise RuntimeError("overflow at full-data capacity — sampler bug")
        self._alg = self._alg.grow()

    def _fit(self, state):
        """``state`` at the group capacity: a lossless re-gather of its
        capacity-shaped δ buffer, zero likelihood queries."""
        if state.sampler.aux.shape[-1] == self.capacity:
            return state
        return self._alg.resize(state)

    # ----------------------------------------------------------- admission

    def build_lane(self, job: job_lib.Job) -> tuple[dict, bool]:
        """A fresh lane for ``job`` at the current group capacity, and
        whether its initial bright set overflowed (one host read)."""
        alg = job_lib.build_algorithm(
            job, capacity=self.capacity, cand_capacity=self.cand_capacity
        )
        states, chain_keys = job_lib.chain_rows(job, alg)
        self.inits += 1
        over = bool(alg.init_overflow(states).any())
        pos0, info0 = alg.output_structs(states)
        carries = {name: col.init(self.max_samples, pos0, info0)
                   for name, col in self.colls.items()}
        return {"job_id": job.job_id, "state": states, "keys": chain_keys,
                "data": alg.data, "stats": alg.stats, "carries": carries,
                "count": 0}, over

    def _init_lane(self, job: job_lib.Job) -> dict:
        """A fresh lane, the group grown until its initial bright set fits:
        the driver's init-overflow loop at group scope."""
        while True:
            lane, over = self.build_lane(job)
            if not over:
                return lane
            self._grow()

    def admit(self, job: job_lib.Job):
        """Join a fresh job (between chunks)."""
        if job_lib.group_key(job) != self.group_key:
            raise ValueError(f"job {job.job_id!r} does not match this group")
        if job.job_id in self._jobs:
            raise ValueError(f"job {job.job_id!r} already admitted")
        self._append(job, self._init_lane(job))

    def admit_restored(self, job: job_lib.Job, lane: dict):
        """Re-join a suspended job's lane: its state carries its iteration
        counters and its keys are the originals, so its key stream goes on
        where it stopped. A lane saved at a larger capacity grows the
        group (shrinking a state would lose δ rows)."""
        if job.job_id in self._jobs:
            raise ValueError(f"job {job.job_id!r} already admitted")
        saved = lane["state"].sampler.aux.shape[-1]
        while self.capacity < min(saved, self._n):
            self._grow()
        lane = dict(lane, state=self._fit(lane["state"]))
        self._append(job, lane)

    def _append(self, job: job_lib.Job, lane: dict):
        self._lanes.append(lane)
        self._jobs[job.job_id] = job

    def lane_of(self, job_id: str) -> dict:
        """A job's lane, not removed."""
        return self._lanes[self._lane_index(job_id)]

    def evict(self, job_id: str) -> dict:
        """Remove a job between chunks; returns its lane."""
        lane = self._lanes.pop(self._lane_index(job_id))
        del self._jobs[job_id]
        return lane

    # ------------------------------------------------------------ the chunk

    def _run_lane(self, lane: dict, state, cs: int):
        """``cs`` steps of one lane from ``state``: the solo driver's chunk
        (:func:`repro_torch.api.driver.run_steps`) on the lane's own data.
        Returns the final state, the ``(position, StepStats)`` outputs, and
        the lane's overflow and health flags as device tensors (no host
        wait). The health flag is the driver's ``health_check`` predicate
        over the outputs, the final state and the lane's dataset."""
        data, stats = lane["data"], lane["stats"]
        step_data = self._alg.step_data

        def step(keys, st):
            return step_data(keys, st, data, stats)

        final, outs, overflow = driver.run_steps(
            step, self._alg.position_of, lane["keys"], state, cs)
        self.lane_steps += cs
        self.group_steps += cs
        return final, outs, overflow, driver.chunk_health(outs, final, data)

    @staticmethod
    def _stacked_data(lanes: list[dict]):
        """The lanes' datasets and statistics as lane stacks (leaves
        ``(L, ...)``); one lane's are views of its own tensors."""

        def stack(trees, kind):
            return kind(*(torch.stack(leaves) if len(lanes) > 1
                          else leaves[0].unsqueeze(0)
                          for leaves in zip(*trees)))

        return (stack([lane["data"] for lane in lanes], GLMData),
                stack([lane["stats"] for lane in lanes], CollapsedStats))

    def _run_stacked(self, lanes: list[dict], states: list, cs: int):
        """``cs`` steps of every lane at once (``"vmap"``): one
        chain-batched ``flymc_step`` a step over the lanes' L·K chains on
        the lane stack of their datasets, keyed by each lane's own
        ``fold_in(chain_keys, iteration)``. Returns, per lane, what
        :meth:`_run_lane` returns; the health flag is the same predicate
        over the lane's outputs, final state and dataset."""
        n_lanes, k = len(lanes), self.num_chains
        data, stats = self._stacked_data(lanes)
        step_data = self._alg.step_data

        def step(keys, st):
            return step_data(keys, st, data, stats)

        final, outs, _ = driver.run_steps(
            step, self._alg.position_of,
            torch.cat([lane["keys"] for lane in lanes]), _cat(states), cs)
        self.lane_steps += cs * n_lanes
        self.group_steps += cs
        infos = StepStats(*(torch.stack(f)
                            for f in zip(*(info for _, info in outs))))
        pos = torch.stack([p for p, _ in outs])
        over = _by_lane(infos.overflow, n_lanes, 1).reshape(
            cs, n_lanes, -1).any(dim=2).any(dim=0)
        leaves = ([_by_lane(pos, n_lanes, 1).movedim(1, 0)]
                  + [_by_lane(f, n_lanes, 1).movedim(1, 0) for f in infos
                     if f.is_floating_point()]
                  + [_by_lane(a, n_lanes) for a in driver._float_leaves(final)]
                  + driver._float_leaves(data))
        ok = driver.finite_lanes(leaves)
        runs = []
        for i in range(n_lanes):
            a, b = i * k, (i + 1) * k
            lane_outs = [(p[a:b], _rows(info, a, b)) for p, info in outs]
            runs.append((_rows(final, a, b), lane_outs, over[i], ok[i]))
        return runs

    def run_chunk(self, chunk_size: int) -> int:
        """Advance every lane ``chunk_size`` steps and fold the committed
        outputs (a job's overshoot past ``max_samples`` skipped). Returns
        the number of overflow re-runs.

        The chunk's one host wait reads every lane's overflow and health
        flags together. Only a healthy lane's overflow grows the group
        (NaN comparisons can assert overflow forever).

        Transactional: ``flymc_step`` never writes into its input state,
        and the collectors' in-place updates go into deep clones of the
        lanes' carries (:func:`repro_torch.api.collectors.clone_carry`);
        the lanes, with their new states and carries, replace the old ones
        only once every lane has folded. So a raise anywhere, in a step or
        in a collector's ``update``, leaves the engine at the previous
        boundary and the retried chunk is bitwise the same chunk. Lanes
        start each attempt at the group capacity, also after a growth whose
        re-run raised.

        **Quarantine.** A lane the sentinel marks unhealthy is neither
        folded nor advanced: its pre-chunk state and carries stay as they
        were, and its job id goes to :meth:`take_quarantined`. Its
        neighbours commit the chunk as if it had never been admitted.
        """
        if not self._lanes:
            return 0
        cs = int(chunk_size)
        lanes = list(self._lanes)
        prevs = [self._fit(lane["state"]) for lane in lanes]
        reruns = 0
        while True:
            if self.lane_backend == "vmap":
                runs = self._run_stacked(lanes, prevs, cs)
            else:
                runs = [self._run_lane(lane, prev, cs)
                        for lane, prev in zip(lanes, prevs)]
            flags = torch.stack([torch.stack([over, ok])
                                 for _, _, over, ok in runs]).tolist()
            self.waits += 1  # the chunk's one host wait
            if not any(over and ok for over, ok in flags):
                break
            # Grow and re-run this chunk from the saved pre-chunk states:
            # the same keys (they come from the states' iteration counters),
            # bigger buffers, bitwise the unbounded chain.
            reruns += 1
            self._grow()
            prevs = [self._alg.resize(prev) for prev in prevs]
        fold = driver.make_collector_fold(self.colls,
                                          max_count=self.max_samples)
        committed, sick = [], []
        for lane, prev, (final, outs, _, _), (_, ok) in zip(
                lanes, prevs, runs, flags):
            if not ok:
                sick.append(lane["job_id"])
                committed.append(dict(lane, state=prev))
                continue
            carries, count = fold(collectors_lib.clone_carry(lane["carries"]),
                                  lane["count"], outs)
            committed.append(dict(lane, state=final, carries=carries,
                                  count=count))
        self._lanes = committed
        self._quarantined.extend(sick)
        self.chunks += 1
        self.reruns += reruns
        return reruns

    def take_quarantined(self) -> list[str]:
        """Job ids the last chunk's sentinel quarantined (their lanes hold
        the pre-chunk committed state); clears the list."""
        out, self._quarantined = self._quarantined, []
        return out

    # ------------------------------------------------------------- readouts

    def committed(self, job_id: str) -> int:
        """Folded samples for this job (a host count: no device read)."""
        return self.lane_of(job_id)["count"]

    def peek(self, job_id: str, name: str):
        """A collector's would-be result for one job, mid-run, without
        touching its carry (:func:`repro_torch.api.collectors.peek`; the
        carry has its leading (K,) chain axis, as ``finalize`` expects)."""
        carry = self.lane_of(job_id)["carries"][name]
        return collectors_lib.peek(self.colls[name], carry)

    def finalize_lane(self, lane: dict) -> dict:
        """{name: finalized result} for an evicted lane: what a solo
        ``Trace.results`` holds."""
        return finalize_lane_with(self.colls, lane)


def finalize_lane_with(colls: dict, lane: dict) -> dict:
    """Finalized ``{name: result}`` of a lane's carries under ``colls``."""
    return {name: col.finalize(lane["carries"][name])
            for name, col in colls.items()}
