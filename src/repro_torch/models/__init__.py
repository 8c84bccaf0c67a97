"""The LM family of the port: layers, attention with KV caches, the dense
transformer, the ``Model`` facade."""
