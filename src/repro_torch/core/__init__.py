"""hlslib-style infrastructure the serving stack needs (streams, dataflow)."""
