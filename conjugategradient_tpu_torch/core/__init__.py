"""Host-side containers, generators and the fp64 oracle."""
