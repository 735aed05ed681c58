"""The plain reference: NumPy only, nothing of the program under test."""
