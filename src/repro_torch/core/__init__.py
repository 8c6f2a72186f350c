"""The hlslib core: streams, dataflow, shift registers, tree reduction,
DataPack."""
