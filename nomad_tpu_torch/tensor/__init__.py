"""Array tables the solver consumes (the array half of the reference's
tensor/pack.py; packing from Node structs comes with a later slice)."""
