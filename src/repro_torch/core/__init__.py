"""Physics-side helpers of the port: bit-plane codecs and the energy model."""
