"""The systems under test: one module a stepper route of the program, named
by a cell's "system". Each builds the program's problem and stepper from a
configuration and the cell's stepper settings, timing each with a sync."""
