"""Cluster state the solver reads (the alloc-delta journal half of the
reference's state store; the tables themselves come with the structs
slice)."""
