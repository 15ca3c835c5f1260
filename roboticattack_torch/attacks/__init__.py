"""Adversarial-patch attacks of the port: objectives, optimizer, the attack
step, the runner and its artifacts."""
