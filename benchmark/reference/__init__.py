"""The plain reference that decides `correct`, worked out from the
generated reads with torch, numpy and plain Python; it imports nothing
of the program: dbg.py (build, clean -T -U, unitigs), links.py
(threading with gap filling), compare.py (the comparisons) and
checks/<name>.py (one per traffic mix's kind of output, named by the
mix)."""
