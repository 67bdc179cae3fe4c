"""Collectives of the port: the paper's schedules (``schedules``), their
postal cost models (``cost_model``, ``autotune``), the rank grid
(``topology``), the message recorder (``comm_record``) and the collectives
over ``torch.distributed`` (``collectives``)."""
