"""Spiking-network runtime of the port: neuron models, synapse groups, the
network IR, the simulator and the ModelSpec front-end."""
