"""Distribution: the logical-axis sharding rules (``sharding``)."""
