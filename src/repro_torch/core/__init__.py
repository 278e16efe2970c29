"""Selection science of the port: Hellinger geometry, OPTICS clustering,
Algorithm 1 and the communication ledger."""
