"""The data-parallel layer of the port on ``torch.distributed``: the
mesh's data axes, the sharded map and the slot-ordered collectives
(``sharding``), and a launcher of local gloo ranks (``ranks``)."""
