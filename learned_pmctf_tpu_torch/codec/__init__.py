"""Real-bitstream codecs: device sub-graphs plus host rANS."""
