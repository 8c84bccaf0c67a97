"""SNN core of the port: codegen, the simulator and ModelSpec, conductance
scaling and the paper's models."""
