"""The port's observability plane: so far the loss sentinel and the
heartbeat files (ROADMAP.md item 17); spans, the meter, the recorder and
the watchdog are item 18."""
