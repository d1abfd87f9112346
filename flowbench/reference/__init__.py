"""The plain reference: float64 PyTorch finite elements written from the
weak forms, imports nothing of the program; one module a problem kind,
named by a configuration's "problem"."""
