"""The plain fp32 reference of the benchmark's configurations: its own
4-bit quantizer (:mod:`.quant`) and forward (:mod:`.model`). It imports
nothing of the program under test."""
