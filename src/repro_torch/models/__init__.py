"""Models of the port: the LM family (``transformer``), the GNN family
(``gnn``) and BST (``bst``), on the shared substrate (``common``)."""
