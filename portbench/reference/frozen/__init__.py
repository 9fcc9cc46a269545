"""A frozen copy of the port's plain PyTorch paths, as they stood when the
benchmark was written: the rigid-body physics (builder, narrowphase, joints,
the colored sequential-impulse solve), the humanoid ragdoll, the locomotion
env's step, the atrium's meshes and the camera.  Trimmed to what the
reference runs (no terrain, broadphase, force fields or kernels) and
importing nothing of the port, so that a later change to the port does not
move the yardstick it is held to."""
