"""Configurations ported so far: the paper's FIR testbed (``fir30``)."""
