"""FP8 formats, Table 2/3 carry-ins, LNS constants, the tensor codec and
the threefry PRNG twin: the numeric core of the PyTorch port."""
