"""Launchers (reference ``repro.launch``): ``train`` and ``serve``; the
analytic cost model and the H100 roofline (``analytic``, ``roofline``);
meshes over ``torch.distributed`` and the sharding rules (``mesh``,
``sharding``)."""
