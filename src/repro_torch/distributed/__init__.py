"""Data-sharded FlyMC and chain fleets on ``torch.distributed``.

Port of :mod:`repro.distributed` (its FlyMC half): :mod:`.flymc_dist`
shards one chain's data rows over the ranks of a process group, or a
fleet's chains; :mod:`.comm` holds the counted collectives the step makes;
:mod:`.launch` starts W ranks as processes on this host. The LM stack's
tensor-parallel and FSDP helpers (the reference's ``par.py``) are not
ported (ROADMAP queue 1, item 9f).

Nothing here is imported by :mod:`repro_torch.core` at module import; the
step reaches :mod:`.comm` only when its spec names a process group.
"""
