"""Fault-tolerance and straggler policies (pure Python, copied from the JAX
package as data: neither module imports JAX)."""
