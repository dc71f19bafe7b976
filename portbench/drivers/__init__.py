"""One module per entry point that a traffic file can drive (its
``driver`` key): ``prepare(ctx)`` builds the cell and warms its shapes,
``window(state, seconds, tracer)`` runs the measured closed loop and
returns its record, ``outputs(state)`` hands what the timed path
produced to the correctness check and frees the program's state."""
