"""The plain reference that decides `correct`: what a sniffer that meets
the configuration's guarantees reports for the block the transmitter
sent (from the transmitter's truth alone), and the comparison of the
program's outputs with it.  NumPy and the standard library only; nothing
of the port.
"""
