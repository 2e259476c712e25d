"""The plain reference the benchmark's outputs are held to. It imports
nothing of the program under test."""
