"""Models of the port: the LM family (``transformer``) on the shared
substrate (``common``).  The GNN and BST models are not ported yet."""
