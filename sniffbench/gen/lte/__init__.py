"""A frozen copy of the port's `phy/` modules that the benchmark's
transmitter needs: numbers, tables, coding and sequences, NumPy only.

The device-side functions of the originals are left out.  The benchmark's
input does not move when the port's own copies change.
"""
