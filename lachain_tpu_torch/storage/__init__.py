"""The storage layer of the port: so far the key-value seam (`kv.py`) that
the consensus journal and the evidence store write through, and the crash
points (`crashpoints.py`) its atomic batch is instrumented with."""
