"""Launchers (reference ``repro.launch``): ``train`` and ``serve`` on one
device.  The mesh, sharding, dry-run and roofline launchers are ROADMAP
A10's distributed half."""
