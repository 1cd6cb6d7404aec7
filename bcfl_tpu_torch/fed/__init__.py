"""Federated rounds and the engine (port of ``bcfl_tpu/fed``)."""
