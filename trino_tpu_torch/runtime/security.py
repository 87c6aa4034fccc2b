"""Access control SPI + file-based implementation.

Reference: security/AccessControlManager.java:98 — a layered chain of
SystemAccessControl implementations consulted before planning/execution
(checkCanSelectFromColumns, checkCanInsertIntoTable, ...), with the
file-based plugin (plugin/trino-file-based-access-control) expressing
user/table/privilege rules as JSON.

The engine enforces at the same seams the reference does:
- SELECT: every TableScan in the final plan (post view/CTE expansion, so
  derived access is checked against base tables)
- INSERT / DELETE / UPDATE / MERGE / CREATE / DROP: statement dispatch
- SET SESSION: property writes
"""

from __future__ import annotations

import abc
import fnmatch
import json
from typing import Optional, Sequence

__all__ = [
    "AccessDeniedError", "AccessControl", "AllowAllAccessControl",
    "FileBasedAccessControl",
]


class AccessDeniedError(Exception):
    """Reference: spi/security/AccessDeniedException."""


class AccessControl(abc.ABC):
    @abc.abstractmethod
    def check_can_select(
        self, user: str, catalog: str, table: str, columns: Sequence[str]
    ) -> None: ...

    @abc.abstractmethod
    def check_can_write(
        self, user: str, catalog: str, table: str, operation: str
    ) -> None: ...

    def check_can_set_session(self, user: str, name: str) -> None:
        return None


class AllowAllAccessControl(AccessControl):
    def check_can_select(self, user, catalog, table, columns) -> None:
        return None

    def check_can_write(self, user, catalog, table, operation) -> None:
        return None


class FileBasedAccessControl(AccessControl):
    """Rules (dict or JSON file path), first-match-wins like the reference:

    {
      "tables": [
        {"user": "alice", "catalog": "*", "table": "*",
         "privileges": ["SELECT", "INSERT", "DELETE", "OWNERSHIP"]},
        {"user": "*", "catalog": "tpch", "table": "nation",
         "privileges": ["SELECT"]}
      ],
      "session_properties": [
        {"user": "*", "property": "*", "allow": true}
      ]
    }

    Globs (fnmatch) in user/catalog/table/property.  No matching rule ==
    denied (the reference's file-based control is also default-deny for
    tables once rules are present).
    """

    _WRITE_PRIVS = {
        "insert": "INSERT",
        "delete": "DELETE",
        "update": "UPDATE",
        "merge": "UPDATE",
        "create": "OWNERSHIP",
        "drop": "OWNERSHIP",
        "truncate": "DELETE",
    }

    def __init__(self, rules):
        if isinstance(rules, str):
            with open(rules) as fh:
                rules = json.load(fh)
        self.table_rules = rules.get("tables", [])
        self.session_rules = rules.get("session_properties", [])

    def _table_privileges(self, user: str, catalog: str, table: str) -> set:
        for r in self.table_rules:
            if (
                fnmatch.fnmatch(user, r.get("user", "*"))
                and fnmatch.fnmatch(catalog, r.get("catalog", "*"))
                and fnmatch.fnmatch(table, r.get("table", "*"))
            ):
                return set(r.get("privileges", []))
        return set()

    def check_can_select(self, user, catalog, table, columns) -> None:
        privs = self._table_privileges(user, catalog, table)
        if "SELECT" not in privs and "OWNERSHIP" not in privs:
            raise AccessDeniedError(
                f"Access Denied: Cannot select from {catalog}.{table} (user {user})"
            )

    def check_can_write(self, user, catalog, table, operation) -> None:
        privs = self._table_privileges(user, catalog, table)
        need = self._WRITE_PRIVS.get(operation, "OWNERSHIP")
        if need not in privs and "OWNERSHIP" not in privs:
            raise AccessDeniedError(
                f"Access Denied: Cannot {operation} {catalog}.{table} (user {user})"
            )

    def check_can_set_session(self, user, name) -> None:
        for r in self.session_rules:
            if fnmatch.fnmatch(user, r.get("user", "*")) and fnmatch.fnmatch(
                name, r.get("property", "*")
            ):
                if r.get("allow", True):
                    return None
                break
        raise AccessDeniedError(
            f"Access Denied: Cannot set session property {name} (user {user})"
        )
