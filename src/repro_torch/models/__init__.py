"""Model zoo: parameter declarations, layers, forward, cache layouts."""
