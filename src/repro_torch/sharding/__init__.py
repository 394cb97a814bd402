"""Tensor-parallel sharded serving: the serve-mode sharding rules
(``rules``) and the ranks and collectives that run them (``comm``)."""
