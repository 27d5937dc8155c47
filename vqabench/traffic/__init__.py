"""The benchmark's traffic: one parameter file a mix, one general loop a kind."""
