"""The benchmark's harness: it finds a cell, its configuration, its
traffic mix, its per-layer metric readers and its check by name, makes
the inputs from the seed, drives the port's CLI in process, and prints
the result line.  See benchmark/run.py."""
