"""The network layer of the port: so far the seeded fault plans
(`faults.py`) that the consensus simulators execute."""
