"""The plain reference: NumPy answers of every timed entry, computed from the
generated columns (never from the program's files, outputs or tables), the
comparison that decides `correct`, and each entry's controls. Imports
nothing of the program and nothing of JAX."""
