"""Parallelism of the PyTorch port: the mesh (``mesh``), the plan grammar
(``plan``), tensor parallelism (``tensor_parallel``), FSDP placement
(``fsdp``), sequence parallelism (``ring_attention``, ``ulysses``) and
expert parallelism (``expert``)."""
