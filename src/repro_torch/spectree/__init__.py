"""Tree-structured speculative decoding (SpecInfer-style multi-path
drafts): ``TreeSpec`` and ``tree_round``; the verify pass scores every
node in one target decode through the tree attention kernel."""
