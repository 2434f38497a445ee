"""Elle's host side: inference of typed dependency planes from a
transactional history (`elle.infer`)."""
