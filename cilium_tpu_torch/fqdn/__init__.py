"""fqdn: the DNS name-pattern matcher the policy compiler uses."""
