"""The benchmark's transmitter: a frozen copy of the port's test-side
encoder and scenario builders, driven by the traffic files of
`sniffbench/traffic/`.  It imports NumPy only, and nothing of the port.
"""
