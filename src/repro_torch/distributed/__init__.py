"""Data-sharded FlyMC, chain fleets and the LM stack's sharding on
``torch.distributed``.

Port of :mod:`repro.distributed`: :mod:`.flymc_dist` shards one chain's
data rows over the ranks of a process group, or a fleet's chains;
:mod:`.par` is the LM stack's axis context, collectives with their
autograd transposes, and weight placement (the reference's ``par.py``);
:mod:`.comm` holds the counted collectives both make; :mod:`.launch`
starts W ranks as processes on this host.

Nothing here is imported by :mod:`repro_torch.core` at module import; the
step reaches :mod:`.comm` only when its spec names a process group.
"""
