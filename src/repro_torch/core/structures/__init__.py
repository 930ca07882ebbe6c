"""The paper's concurrent data structures over the simulator: Harris-Michael
list, lazy list, hash table, external BST (copies of the reference's)."""
