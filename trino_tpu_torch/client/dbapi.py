"""PEP 249 (DB-API 2.0) driver over the statement protocol.

The reference ships a JDBC driver (client/trino-jdbc/.../TrinoDriver.java:21)
layered on its client protocol library; in the Python ecosystem the
equivalent standard surface is DB-API: ``connect() -> Connection ->
cursor() -> execute()/fetch*()``, usable by sqlalchemy-style tooling and
anything that expects a PEP 249 driver.

    from trino_tpu_torch.client.dbapi import connect
    conn = connect("http://127.0.0.1:8080")
    cur = conn.cursor()
    cur.execute("select n_name from nation where n_regionkey = 0")
    rows = cur.fetchall()
"""

from __future__ import annotations

import datetime
import decimal
import hashlib
from typing import Any, Iterator, Optional, Sequence

from .client import QueryFailed, StatementClient

apilevel = "2.0"
threadsafety = 2  # threads may share the module and connections
paramstyle = "qmark"

__all__ = [
    "connect", "Connection", "Cursor",
    "Error", "DatabaseError", "ProgrammingError", "OperationalError",
    "apilevel", "threadsafety", "paramstyle",
]


class Error(Exception):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


def _render_literal(v: Any) -> str:
    """One parameter value as a single typed literal token for EXECUTE...
    USING.  Unlike the old qmark text substitution this never splices user
    data into the statement body: the statement ships verbatim (via the
    prepared registry header) and the value arrives as one literal the
    server binds by type — a quote in a string can only ever extend the
    string token ('' doubling), never terminate the expression."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        # exponent form lexes as an approximate (DOUBLE) literal; a bare
        # "24.0" would lex as exact decimal(3,1) and change the slot type
        return f"{v!r}e0" if "e" not in repr(v) else repr(v)
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return f"date '{v.isoformat()}'"
    return "'" + str(v).replace("'", "''") + "'"


def _prepared_name(operation: str) -> str:
    # deterministic per statement text: repeated execute() of the same
    # operation reuses one registry slot (and one server plan-cache entry)
    return "dbapi_" + hashlib.sha1(operation.encode()).hexdigest()[:12]


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: Optional[list[tuple]] = None
        self._pos = 0
        self.description: Optional[list[tuple]] = None
        self.rowcount = -1

    # ------------------------------------------------------------- execute
    def execute(self, operation: str, parameters: Sequence[Any] = ()) -> "Cursor":
        if self._conn._client is None:
            raise ProgrammingError("connection is closed")
        if parameters:
            # bind, don't splice: the statement text goes into the client's
            # prepared registry (shipped by header, cached server-side by
            # the parameterized plan cache) and values travel as typed
            # EXECUTE ... USING literals
            n_slots, in_str = 0, False
            for c in operation:
                if c == "'":
                    in_str = not in_str
                elif c == "?" and not in_str:
                    n_slots += 1
            if len(parameters) != n_slots:
                raise ProgrammingError(
                    f"statement takes {n_slots} parameters, got {len(parameters)}"
                )
            name = _prepared_name(operation)
            self._conn._client.prepared[name] = operation
            sql = f"EXECUTE {name} USING " + ", ".join(
                _render_literal(v) for v in parameters
            )
        else:
            sql = operation
        try:
            columns, rows = self._conn._client.execute(sql)
        except QueryFailed as e:
            raise DatabaseError(str(e)) from e
        except OSError as e:
            raise OperationalError(str(e)) from e
        self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        # DB-API description: (name, type_code, None, None, None, None, null_ok)
        self.description = [
            (c, None, None, None, None, None, True) for c in (columns or [])
        ]
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    # --------------------------------------------------------------- fetch
    def fetchone(self) -> Optional[tuple]:
        if self._rows is None:
            raise ProgrammingError("no query has been executed")
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> list[tuple]:
        n = size or self.arraysize
        out = self._rows[self._pos : self._pos + n] if self._rows else []
        self._pos += len(out)
        return out

    def fetchall(self) -> list[tuple]:
        if self._rows is None:
            raise ProgrammingError("no query has been executed")
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def __iter__(self) -> Iterator[tuple]:
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    # ------------------------------------------------------------- no-ops
    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def close(self) -> None:
        self._rows = None


class Connection:
    def __init__(self, url: str):
        self._client: Optional[StatementClient] = StatementClient(url)

    def cursor(self) -> Cursor:
        if self._client is None:
            raise ProgrammingError("connection is closed")
        return Cursor(self)

    def commit(self) -> None:
        pass  # autocommit engine

    def rollback(self) -> None:
        raise DatabaseError("rollback is not supported (autocommit engine)")

    def close(self) -> None:
        self._client = None

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(url: str) -> Connection:
    return Connection(url)
