"""Sparse synapse storage of the port: ELL containers, host initializers,
the paper's memory model and the accumulation ops."""
