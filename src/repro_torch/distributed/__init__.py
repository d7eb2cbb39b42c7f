"""The sharding layer of the port on ``torch.distributed``: the LM
params' logical-axis layout, the mesh's data axes, the sharded map and
the slot-ordered collectives (``sharding``), a launcher of local gloo
ranks (``ranks``), and the bodies of the multi-rank checks
(``checks``)."""
